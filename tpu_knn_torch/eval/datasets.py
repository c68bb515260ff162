"""Synthetic benchmark datasets (counterpart of tpu_knn/eval/datasets.py).

Real ANN benchmark sets (SIFT-1M, GloVe-1.2M) can't be fetched in a
sealed environment, so benchmarks use clustered synthetic data with a
realistic *intrinsic* dimensionality instead: uniform random 128-d data
is near-equidistant (intrinsic dim == d, the provable worst case for
any ANN index), while real descriptor data has intrinsic dim ~10-20.

``sift_like`` mimics SIFT's statistics: a GMM with a few thousand
centers on a low-dimensional latent manifold, non-negative, scaled to
the u8 range. Pure numpy: the same seed gives the same bits as tpu_knn.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..utils.rng import np_rng

#: On-disk cache for generated sets: host RNG throughput dominates on
#: small hosts. Defaults to the checkout's ``.datacache/`` (git-ignored);
#: ``TPU_KNN_DATA_CACHE`` overrides it.
_CACHE_DIR = os.environ.get(
    "TPU_KNN_DATA_CACHE", str(Path(__file__).resolve().parents[2] / ".datacache")
)


def _cached(key: str, maker):
    path = os.path.join(_CACHE_DIR, key + ".npy")
    try:
        return np.load(path)
    except OSError:
        pass
    x = maker()
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = os.path.join(_CACHE_DIR, f".{key}.{os.getpid()}.tmp.npy")
        np.save(tmp, x)
        os.replace(tmp, path)
    except OSError:
        pass
    return x


def clustered(
    n: int,
    d: int,
    n_clusters: int = 1000,
    latent_dim: int = 16,
    noise: float = 0.15,
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """GMM on a ``latent_dim``-dimensional manifold embedded in R^d."""
    rng = np_rng(seed)
    f32 = np.float32
    basis = rng.standard_normal((latent_dim, d), dtype=f32) / np.sqrt(latent_dim)
    centers_lat = rng.standard_normal((n_clusters, latent_dim), dtype=f32)
    assign = rng.integers(0, n_clusters, size=n)
    lat = centers_lat[assign] + noise * rng.standard_normal((n, latent_dim), dtype=f32)
    x = lat @ basis + (noise * 0.5) * rng.standard_normal((n, d), dtype=f32)
    return x.astype(dtype, copy=False)


def sift_like(n: int, d: int = 128, seed: int = 0) -> np.ndarray:
    """Non-negative clustered f32 vectors scaled to the u8 value range,
    mimicking SIFT descriptor statistics (sparse-ish, clustered)."""

    def make():
        x = clustered(n, d, n_clusters=max(n // 500, 64), latent_dim=16, seed=seed)
        x = np.maximum(x - np.percentile(x, 30), 0.0)
        mx = np.percentile(x, 99.9)
        return np.clip(x * (255.0 / max(mx, 1e-6)), 0, 255).astype(np.float32)

    return _cached(f"sift_like_{n}x{d}_s{seed}", make)


def glove_like(n: int, d: int = 100, seed: int = 0) -> np.ndarray:
    """Zero-mean clustered vectors, GloVe-style (used with cosinesimil)."""
    return _cached(
        f"glove_like_{n}x{d}_s{seed}",
        lambda: clustered(n, d, n_clusters=max(n // 300, 64), latent_dim=24, seed=seed),
    )


def sparse_like(
    n: int,
    vocab: int = 30_000,
    nnz: int = 64,
    n_clusters: int = 200,
    topic_frac: float = 0.7,
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Clustered bag-of-words corpus for the sparse spaces: a Zipfian
    global term distribution plus per-cluster topic terms (a document draws
    ``topic_frac`` of its terms from its cluster's topic set). Returns
    ragged [(ids, vals)] with 1-based strictly increasing int32 ids (the
    sparse API contract) and log-tf-style positive f32 values; repeated
    terms of a document keep their first draw. The same draws as
    tpu_knn's, so one seed gives one corpus in both packages."""

    def make():
        rng = np_rng(seed)
        # global Zipf-ish inverse-CDF over term ranks
        p = 1.0 / (np.arange(vocab) + 10.0)
        cdf = np.cumsum(p) / p.sum()
        topic_terms = rng.integers(0, vocab, size=(n_clusters, max(nnz * 8, 256)))
        cl = rng.integers(0, n_clusters, size=n)
        glob = np.searchsorted(cdf, rng.random((n, nnz))).clip(0, vocab - 1)
        # topic_terms[cl[:, None], j] is tpu_knn's topic_terms[cl][arange(n)[:, None], j] without the
        # [n, 512] copy
        topi = topic_terms[cl[:, None], rng.integers(0, topic_terms.shape[1], size=(n, nnz))]
        use_topic = rng.random((n, nnz)) < topic_frac
        ids = np.where(use_topic, topi, glob).astype(np.int64)
        vals = (1.0 + np.log1p(rng.poisson(1.0, size=(n, nnz)))).astype(np.float32)
        out = np.zeros((n, nnz, 2), np.float32)
        out[:, :, 0] = ids
        out[:, :, 1] = vals
        return out

    # ids ride in a float32 cache slab: above 2^24 distinct integers stop
    # being representable and distinct terms would merge
    if vocab > 1 << 24:
        raise ValueError(f"sparse_like vocab {vocab} exceeds the f32-exact integer range (2^24)")
    packed = _cached(f"sparse_like_{n}x{vocab}x{nnz}_s{seed}", make)
    ids = packed[:, :, 0].astype(np.int64)
    order = np.argsort(ids, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, 1)
    vals = np.take_along_axis(packed[:, :, 1], order, 1)
    keep = np.ones_like(ids, dtype=bool)
    keep[:, 1:] = ids[:, 1:] != ids[:, :-1]  # dedup: the first of equal ids stays
    splits = np.cumsum(keep.sum(axis=1))[:-1]
    out_ids = np.split((ids[keep] + 1).astype(np.int32), splits)
    out_vals = np.split(vals[keep].astype(np.float32), splits)
    return list(zip(out_ids, out_vals))
