"""The benchmark's inputs, made on the device from ``--seed``.

Frozen torch rewrites of two recipes of ``tpu_knn_torch/eval/datasets.py``
(which are host numpy and too slow at a million rows):

* ``sift_like``: a Gaussian mixture on a low-dimensional manifold embedded
  in R^d, shifted, clipped at zero and scaled to the u8 range, as SIFT
  descriptors are (``clustered`` then ``sift_like`` there);
* ``sparse_like``: a bag-of-words corpus, each row a mix of Zipf-distributed
  global terms and its topic's terms, log-tf weights, repeated terms keeping
  their first draw (``sparse_like`` there).

They draw other numbers than the originals (another generator, on the
card), but by the same recipe. The same seed gives the same inputs on the
same card and software. A configuration names its recipe and the recipe's
parameters; a recipe that this file lacks is looked up as
``knnbench/recipes/<recipe>.py``, whose ``make(config, traffic, seed,
device)`` returns :class:`Inputs`.

Nothing here imports the program: the inputs are handed to it through its
public API by the harness, and to the reference from the same host arrays.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

#: elements torch.quantile takes at most; a quantile of the data is taken
#: over its first this many elements (rows are independent draws)
_QUANTILE_SAMPLE = 1 << 24


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``stream``): each use
    of the seed draws from a stream of its own, so adding one changes no
    other. Any integer seed is taken, however large."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _quantile(x: torch.Tensor, q: float) -> float:
    return float(torch.quantile(x.reshape(-1)[:_QUANTILE_SAMPLE], q))


def sift_like(rows: int, dim: int, clusters: int, latent_dim: int, noise: float, low_quantile: float,
              high_quantile: float, g: torch.Generator, device) -> torch.Tensor:
    """f32 [rows, dim] non-negative clustered rows in [0, 255]."""
    basis = torch.randn(latent_dim, dim, generator=g, device=device) / math.sqrt(latent_dim)
    centers = torch.randn(clusters, latent_dim, generator=g, device=device)
    assign = torch.randint(0, clusters, (rows,), generator=g, device=device)
    lat = centers[assign] + noise * torch.randn(rows, latent_dim, generator=g, device=device)
    x = lat @ basis
    del lat
    x += (0.5 * noise) * torch.randn(rows, dim, generator=g, device=device)
    x -= _quantile(x, low_quantile)
    x.clamp_(min=0.0)
    x *= 255.0 / max(_quantile(x, high_quantile), 1e-6)
    return x.clamp_(0.0, 255.0)


def sparse_like(rows: int, vocab: int, draws: int, topics: torch.Tensor, topic_frac: float, zipf_offset: float,
                g: torch.Generator, device):
    """CSR (indptr i64 [rows+1], 0-based term ids i64, f32 weights) of ``rows``
    bags of ``draws`` terms each before repeats are merged: a draw is one of
    its row's topic terms (``topics`` [clusters, width]) with probability
    ``topic_frac``, else a global term of probability proportional to 1 /
    (rank + ``zipf_offset``); its weight is 1 + log(1 + Poisson(1)). Terms
    of a row are ascending; a repeated term keeps its first draw."""
    p = 1.0 / (torch.arange(vocab, dtype=torch.float64, device=device) + zipf_offset)
    cdf = torch.cumsum(p, 0) / p.sum()
    glob = torch.searchsorted(cdf, torch.rand(rows, draws, generator=g, device=device, dtype=torch.float64))
    glob.clamp_(max=vocab - 1)
    cl = torch.randint(0, topics.shape[0], (rows, 1), generator=g, device=device)
    pick = torch.randint(0, topics.shape[1], (rows, draws), generator=g, device=device)
    topical = torch.rand(rows, draws, generator=g, device=device) < topic_frac
    ids = torch.where(topical, topics[cl, pick], glob)
    del glob, pick, topical
    weights = 1.0 + torch.log1p(torch.poisson(torch.ones(rows, draws, device=device), generator=g))
    ids, order = torch.sort(ids, dim=1, stable=True)
    weights = torch.gather(weights, 1, order)
    keep = torch.ones_like(ids, dtype=torch.bool)
    keep[:, 1:] = ids[:, 1:] != ids[:, :-1]
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(keep.sum(1), 0)
    return indptr, ids[keep], weights[keep].float()


@dataclass
class Inputs:
    """One seed's inputs, on the host.

    ``corpus``: dense f32 [n, d], or sparse CSR (indptr, 0-based term ids,
    weights). ``queries``: the pool, in the same form, ``pool * batch``
    queries. ``ids``: the object id of each corpus row (a permutation of
    0..n-1, so that the answers go through the program's id mapping).
    ``vocab``: the sparse vocabulary (0 for dense)."""

    kind: str
    corpus: object
    queries: object
    ids: np.ndarray
    batch: int
    pool: int
    vocab: int = 0

    @property
    def n(self) -> int:
        return len(self.ids)

    def batch_rows(self, b: int) -> tuple[int, int]:
        return b * self.batch, (b + 1) * self.batch

    def sparse_rows(self, csr, s: int, e: int) -> list:
        """Rows s..e of a CSR as the API's (1-based ids i32, weights f32) pairs."""
        indptr, ids, vals = csr
        lo, hi = int(indptr[s]), int(indptr[e])
        cuts = indptr[s + 1:e] - lo
        return list(zip(np.split((ids[lo:hi] + 1).astype(np.int32), cuts), np.split(vals[lo:hi], cuts)))

    def api_batch(self, b: int):
        """Pool batch ``b`` as the program's query API takes it."""
        s, e = self.batch_rows(b)
        if self.kind == "dense":
            return self.queries[s:e]
        return self.sparse_rows(self.queries, s, e)

    def api_corpus(self):
        """The corpus as the program's add API takes it."""
        if self.kind == "dense":
            return self.corpus
        return self.sparse_rows(self.corpus, 0, self.n)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """Corpus, query pool and object ids of a configuration under a traffic
    mix, from ``seed``. The recipe runs on ``device``; the device copies are
    freed on return."""
    gen = dict(config["generator"])
    recipe = gen.pop("recipe")
    batch, pool = int(traffic["batch"]), int(traffic["pool_batches"])
    nq, n = batch * pool, int(config["n"])
    ids = _host(torch.randperm(n, generator=generator(seed, "ids", device), device=device))
    if recipe == "sift_like":
        x = sift_like(n + nq, int(config["dim"]), g=generator(seed, "rows", device), device=device, **gen)
        rows = _host(x)
        del x
        return Inputs("dense", rows[:n], rows[n:], ids, batch, pool)
    if recipe == "sparse_like":
        vocab = int(config["vocab"])
        width, clusters = int(gen.pop("topic_width")), int(gen.pop("clusters"))
        topics = torch.randint(0, vocab, (clusters, width), generator=generator(seed, "topics", device),
                               device=device)
        common = dict(vocab=vocab, topics=topics, topic_frac=float(gen["topic_frac"]),
                      zipf_offset=float(gen["zipf_offset"]), device=device)
        corpus = sparse_like(n, draws=int(gen["doc_draws"]), g=generator(seed, "rows", device), **common)
        queries = sparse_like(nq, draws=int(gen["query_draws"]), g=generator(seed, "queries", device), **common)
        return Inputs("sparse", tuple(map(_host, corpus)), tuple(map(_host, queries)), ids, batch, pool, vocab)
    from .registry import find

    return find("recipes", recipe).make(config, traffic, seed, device)
