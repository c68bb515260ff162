"""NAPP, the neighbourhood approximation index (registry names napp and
pivot_neighb_invindx; counterpart of tpu_knn/methods/napp.py; reference:
include/method/pivot_neighb_invindx.h, src/method/pivot_neighb_invindx.cc,
permutation_utils.h).

Reference algorithm: pick numPivot pivots; index every object under its
numPrefix closest pivots in chunked inverted files; at query time,
generate candidates by counting how often each object appears in the
posting lists of the query's numPrefixSearch closest pivots (ScanCount),
keep those appearing >= minTimes, then re-rank candidates with real
distances unless skipChecking.

As in tpu_knn, the inverted files become a dense per-object prefix
i32[N, numPrefix], and ScanCount one product per corpus chunk of the
query pivot mask [Q, P+1] by the chunk's one-hot prefixes [C, P+1], an
IEEE f32 ``torch.matmul`` whose 0/1 operands and counts <= numPrefix are
exact in any order. Two query routes (``invProcAlg``):

  * ``scan``: counting, candidate masking, exact scoring of the masked
    block and the dist-comp accounting in one streaming pass over the
    corpus (:func:`_napp_knn`); ``skipChecking`` ranks by count instead;
  * ``gather``: per corpus chunk the ``keep`` best candidates by count,
    then only those are gathered and scored (:func:`_napp_knn_gathered`),
    ``keep`` spreading dbScanFrac's budget over the chunks (``_gather_plan``).

How the port differs inside, with equal results: the chunk that plans the
index and the gather route is tpu_knn's on both devices (256 rows for a
sparse space, else the space's preferred chunk, 8192 by default), because
``keep`` depends on it; the streaming passes whose result does not depend
on the chunk (the fused kNN scan and both range passes) run over the
space's own preferred chunk on the device (4080 sparse rows on the card)
with a ragged last step. tpu_knn's ``SCANCOUNT_BACKEND`` switch and its
packed-transport entry points are not ported (A/B and tunnel residue).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataStore, round_up
from ..core.errors import IndexNotBuiltError, InvalidArgumentError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import distance as D
from ..ops import graph as G
from ..ops import topk as T
from ..ops.topk import INF
from ..utils.logging import log
from ..utils.rng import np_rng
from .base import Method, stream_range_results
from .seq_search import _densify, _ids_of, _nq
from .vptree import _gather_xc

#: Corpus rows scored per step of the prefix build (tpu_knn's step).
PREFIX_STEP = 4096


def _stream_topk(chunk_dists, n: int, step: int, b: int, k: int, dev, nan_free: bool = False):
    """ops/topk.streaming_smallest_k over ``n`` rows in ``step``-row slices,
    the last one ragged; ``chunk_dists(start, size)`` gives a [b, size] block."""
    return T.streaming_smallest_k(lambda ci: chunk_dists(ci * step, min(step, n - ci * step)),
                                  -(-n // step), step, b, k, dev, nan_free)


def _napp_candidate_prelude(space, qenc, data, pivot_rows, prefix, prefix_search: int):
    """Shared front of the kNN and range scans: the densified queries, the
    query pivot mask, and ``counts(start, size)`` giving exact integer
    ScanCount values f32[Q, size] for a corpus slice."""
    p = pivot_rows.shape[0]
    qenc = _densify(space, qenc, data)
    b = _nq(qenc)
    dq = space.block(qenc, _gather_xc(space, data, pivot_rows))  # [Q, P]
    qtop = T.smallest_k(dq, min(prefix_search, p))[1]  # lax.top_k(-dq)'s order
    qmask = torch.zeros((b, p + 1), dtype=torch.float32, device=dq.device)
    qmask.scatter_(1, qtop, 1.0)

    def counts(start: int, size: int) -> torch.Tensor:
        pfx = prefix[start:start + size].long()
        safe = torch.where(pfx >= 0, pfx, p)  # pad slots hit the dead column p
        oneh = torch.zeros((size, p + 1), dtype=torch.float32, device=pfx.device)
        oneh.scatter_add_(1, safe, torch.ones_like(safe, dtype=torch.float32))
        return D.matmul(qmask, oneh)

    return qenc, b, counts


def _napp_knn(space, qenc, data, pivot_rows, prefix, k: int, scan_chunk: int, min_times: int,
              skip_checking: bool, prefix_search: int):
    """Fused scan: candidate generation, re-ranking and the dist-comp
    accounting in one streaming pass. Returns (dists, ids, ndist)."""
    p = pivot_rows.shape[0]
    qenc, b, counts = _napp_candidate_prelude(space, qenc, data, pivot_rows, prefix, prefix_search)
    dev = data.ids.device
    # per-query counts: the host sums them in int64 (methods/base.py)
    ncand = torch.zeros(b, dtype=torch.int32, device=dev)

    def chunk_dists(s, c):
        count = counts(s, c)
        cand = count >= min_times
        if skip_checking:
            # rank by count (proxy distance), no real distance evaluations
            return torch.where(cand, -count, INF)
        ncand.add_(cand.sum(dim=1, dtype=torch.int32))
        return torch.where(cand, space.block(qenc, space.slice_data(data, s, c)), INF)

    cd, cpos = _stream_topk(chunk_dists, data.ids.shape[0], scan_chunk, b, k, dev)
    return cd, _ids_of(data, cpos), ncand + p


def _napp_knn_gathered(space, qenc, data, pivot_rows, prefix, k: int, chunk: int, min_times: int,
                       prefix_search: int, keep: int, cand_chunk: int):
    """Candidate-gathered rerank (reference pivot_neighb_invindx.cc:295-340:
    candidate generation, then a rerank of the candidates only).

    Pass A: per ``chunk``-row corpus chunk, keep the ``keep`` best candidate
    positions by ScanCount count (count is the proxy priority, the
    reference's sorted-by-frequency order); the winners form a fixed
    [Q, num_chunks*keep] candidate table. Pass B: gather and score only
    those candidates (ops/graph.score_rows) in ``cand_chunk`` column slices,
    streaming top-k. Returns (dists, ids, ndist)."""
    p = pivot_rows.shape[0]
    qenc, b, counts = _napp_candidate_prelude(space, qenc, data, pivot_rows, prefix, prefix_search)
    dev = data.ids.device
    n_pad = data.ids.shape[0]
    ncand = torch.zeros(b, dtype=torch.int32, device=dev)
    table = []
    for s in range(0, n_pad, chunk):
        count = counts(s, chunk)
        dd = torch.where(count >= min_times, -count, INF)
        cols = torch.arange(s, s + chunk, device=dev).expand(b, chunk)
        cc, cpos = T.smallest_k(dd, keep, cols)
        cpos = torch.where(torch.isinf(cc), -1, cpos)
        # dist-comp accounting = candidates actually scored in pass B
        ncand += (cpos >= 0).sum(dim=1, dtype=torch.int32)
        table.append(cpos)
    cpos = torch.cat(table, dim=1)  # [Q, num_chunks * keep], chunk-major
    # pad the candidate table to a cand_chunk multiple with -1 (scores +INF)
    pad_cols = (-cpos.shape[1]) % cand_chunk
    if pad_cols:
        cpos = torch.cat([cpos, cpos.new_full((b, pad_cols), -1)], dim=1)
    corpus = space.corpus_dict(data)
    fd = torch.full((b, k), INF, dtype=torch.float32, device=dev)
    fi = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, cpos.shape[1], cand_chunk):
        pos = cpos[:, s:s + cand_chunk]
        fd, fi = T.merge_topk(fd, fi, G.score_rows(space, qenc, corpus, pos), pos, k)
    return fd, _ids_of(data, fi), ncand + p


def _napp_range_counts(space, qenc, data, pivot_rows, prefix, radius: float, scan_chunk: int,
                       min_times: int, prefix_search: int):
    """Pass 1 of the NAPP range query: per-query candidate hits within
    ``radius`` (i32[Q]) and the dist-comp tally. The reference answers
    range queries through the kNN candidate path
    (pivot_neighb_invindx.cc:783-785)."""
    qenc, b, counts = _napp_candidate_prelude(space, qenc, data, pivot_rows, prefix, prefix_search)
    dev = data.ids.device
    hits = torch.zeros(b, dtype=torch.int32, device=dev)
    ncand = torch.zeros(b, dtype=torch.int32, device=dev)
    n_pad = data.ids.shape[0]
    for s in range(0, n_pad, scan_chunk):
        c = min(scan_chunk, n_pad - s)
        cand = counts(s, c) >= min_times
        d = torch.where(cand, space.block(qenc, space.slice_data(data, s, c)), INF)
        hits += (d <= radius).sum(dim=1, dtype=torch.int32)
        ncand += cand.sum(dim=1, dtype=torch.int32)
    return hits, ncand + pivot_rows.shape[0]


def _napp_range_collect(space, qenc, data, pivot_rows, prefix, radius: float, cap: int,
                        scan_chunk: int, min_times: int, prefix_search: int):
    """Pass 2: ascending ([Q, cap] dists, positions) of the candidate hits
    within ``radius``, a streaming smallest-cap merge."""
    qenc, b, counts = _napp_candidate_prelude(space, qenc, data, pivot_rows, prefix, prefix_search)

    def chunk_dists(s, c):
        cand = counts(s, c) >= min_times
        d = torch.where(cand, space.block(qenc, space.slice_data(data, s, c)), INF)
        return torch.where(d <= radius, d, INF)  # a NaN distance is no hit

    return _stream_topk(chunk_dists, data.ids.shape[0], scan_chunk, b, cap, data.ids.device, nan_free=True)


def plan_chunk(space) -> int:
    """tpu_knn's preferred chunk of ``space``: 256 rows for a sparse space
    (its ``reference_chunk``, where the port's own is wider on the card),
    else the space's preferred chunk, 8192 by default."""
    return getattr(space, "reference_chunk", getattr(space, "preferred_chunk", 8192))


@register_method("napp")
@register_method("pivot_neighb_invindx")
class Napp(Method):
    name = "napp"
    supports_range = True

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        self.num_pivot = pm.get("numPivot", 512, int)
        self.num_prefix = pm.get_synonym(["numPrefix", "numPivotIndex"], 32, int)
        pm.get("chunkIndexSize", 65536, int)  # parity no-op: no chunked postings
        pm.get("indexThreadQty", 0, int)  # parity no-op
        pm.get("recreatePoints", False, bool)  # parity no-op
        pm.get("hashTrickDim", 0, int)  # parity no-op
        self.pivot_file = pm.get("pivotFile", "", str)
        self.seed = pm.get("seed", 0, int)
        pm.check_unused()
        self._reset_query_params()
        self._prefix = None

    def _reset_query_params(self) -> None:
        # query-time defaults (pivot_neighb_invindx.cc:295-340)
        self.num_prefix_search = self.num_prefix
        self.min_times = 2
        self.skip_checking = False
        self.db_scan_frac = 0.05
        self.inv_proc_alg = "scan"

    def set_query_time_params(self, params: Params | None) -> None:
        if params is None:
            # ResetQueryTimeParams (pivot_neighb_invindx.cc defaults)
            self._reset_query_params()
            super().set_query_time_params(None)
            return
        pm = ParamManager(Params.of(params))
        self.num_prefix_search = pm.get("numPrefixSearch", self.num_prefix_search, int)
        self.min_times = pm.get("minTimes", self.min_times, int)
        self.skip_checking = pm.get("skipChecking", self.skip_checking, bool)
        # the candidate budget of the gather route (reference: dbScanFrac
        # bounds the candidate pool, pivot_neighb_invindx.cc:295-340);
        # ignored by the fused scan
        self.db_scan_frac = pm.get("dbScanFrac", self.db_scan_frac, float)
        pm.get("knnAmp", 0, int)  # parity no-op
        self.inv_proc_alg = pm.get("invProcAlg", self.inv_proc_alg, str)
        if self.inv_proc_alg not in ("scan", "gather"):
            raise InvalidArgumentError(
                f"invProcAlg={self.inv_proc_alg!r}: this build implements "
                "'scan' (fused) and 'gather' (candidate-gathered rerank)")
        pm.get("useSort", False, bool)  # parity no-op
        pm.check_unused()
        super().set_query_time_params(params)

    # ---------------- construction ----------------

    def _set_chunk(self, chunk: int) -> None:
        self._chunk = chunk
        # the chunk-independent streaming passes take the space's own
        # (device-dependent) chunk when it is wider
        self._scan_chunk = max(chunk, getattr(self.space, "preferred_chunk", chunk))

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        n = len(store)
        self._set_chunk(round_up(min(plan_chunk(self.space), round_up(max(n, 1), 8)), 8))
        self.data = self.space.encode_dataset(store, row_multiple=self._chunk)
        if n == 0:
            self._prefix = None
            return
        dev = self.data.ids.device
        p = min(self.num_pivot, n)
        if self.pivot_file:
            piv = np.loadtxt(self.pivot_file, dtype=np.int64).reshape(-1)[:p]
            if piv.size and (piv.min() < 0 or piv.max() >= n):
                # a negative would clip to row 0 with an INF pad, a silently
                # inert pivot: reject it like an overflow
                raise InvalidArgumentError("pivotFile contains out-of-range positions")
        else:
            piv = np_rng(self.seed).choice(n, size=p, replace=False)
        self._pivot_rows = torch.from_numpy(piv.astype(np.int32)).to(dev)
        npfx = min(self.num_prefix, p)
        self._npfx = npfx

        # per-object prefix: the numPrefix closest pivots, in lax.top_k's
        # order. The corpus is encoded as queries once and sliced per step.
        n_pad = self.data.ids.shape[0]
        prefix = torch.full((n_pad, npfx), -1, dtype=torch.int32, device=dev)
        xc_piv = _gather_xc(self.space, self.data, self._pivot_rows)
        qenc_all = self.space.encode_queries(self.space.store_as_query_points(store))
        for lo in range(0, n, PREFIX_STEP):
            hi = min(lo + PREFIX_STEP, n)
            qenc = {key: (v[lo:hi] if v.ndim >= 1 and v.shape[0] >= n else v) for key, v in qenc_all.items()}
            d = self.space.block(qenc, xc_piv)  # [hi-lo, P]
            prefix[lo:hi] = T.smallest_k(d, npfx)[1].to(torch.int32)
        self._prefix = prefix
        log("DEBUG", f"napp built: n={n} pivots={p} prefix={npfx}")

    # ---------------- search ----------------

    def _gather_plan(self, k: int) -> tuple[int, int]:
        """(keep, cand_chunk) for the gathered rerank: the dbScanFrac
        candidate budget spread uniformly over the corpus chunks (8-rounded)."""
        n = int(self.data.count)
        num_chunks = max(self.data.ids.shape[0] // self._chunk, 1)
        budget = max(int(self.db_scan_frac * n), k, 8)
        keep = min(self._chunk, max(8, -(-budget // num_chunks)))
        keep = round_up(keep, 8)
        cand_chunk = min(4096, round_up(num_chunks * keep, 8))
        return keep, cand_chunk

    def _check_built(self) -> None:
        if self._prefix is None:
            raise IndexNotBuiltError("napp: index not built")

    def _knn_run(self, points, k: int):
        """The caller's side of a kNN batch: validate, encode the queries
        and capture every query-time setting (invProcAlg, minTimes,
        numPrefixSearch, skipChecking, the gather plan). Returns (qenc,
        run); run() searches on the device, adds its dist comps and gives
        (dists, ids) as tensors."""
        self._check_built()
        qenc = self.space.encode_queries(points)
        nps = min(self.num_prefix_search, self._pivot_rows.shape[0])
        args = (self.space, qenc, self.data, self._pivot_rows, self._prefix, k)
        if self.inv_proc_alg == "gather" and not self.skip_checking:
            keep, cand_chunk = self._gather_plan(k)
            args += (self._chunk, self.min_times, nps, keep, cand_chunk)
            search = _napp_knn_gathered
        else:
            args += (self._scan_chunk, self.min_times, self.skip_checking, nps)
            search = _napp_knn

        def run():
            d, ids, nd = search(*args)
            self._add_dist_comps(nd)
            return d, ids

        return qenc, run

    def knn(self, points, k: int):
        d, ids = self._knn_run(points, k)[1]()
        return self._finalize_knn(d.cpu().numpy(), ids.cpu().numpy())

    def knn_async(self, points, k: int):
        qenc, run = self._knn_run(points, k)
        return self._dispatch(run, self._finalize_knn, qenc)

    def range(self, points, radius: float):
        """Approximate range search through the kNN candidate pipeline
        (reference pivot_neighb_invindx.cc:783-785: ScanCount candidates
        with >= minTimes shared prefix pivots, then an exact radius check).
        Hits that never make the candidate set are missed, as in the
        reference; seq_search.range is the exact oracle."""
        self._check_built()
        qenc = self.space.encode_queries(points)
        nps = min(self.num_prefix_search, self._pivot_rows.shape[0])
        radius = float(radius)
        counts, nd = _napp_range_counts(
            self.space, qenc, self.data, self._pivot_rows, self._prefix,
            radius, self._scan_chunk, self.min_times, nps,
        )
        self._add_dist_comps(nd)
        return stream_range_results(
            counts.cpu().numpy(),
            self.data,
            lambda cap: _napp_range_collect(
                self.space, qenc, self.data, self._pivot_rows, self._prefix,
                radius, cap, self._scan_chunk, self.min_times, nps,
            ),
        )

    # ---------------- persistence ----------------

    def state_arrays(self) -> dict:
        if self._prefix is None:
            return {}
        return {
            "pivot_rows": self._pivot_rows.cpu().numpy(),
            "prefix": self._prefix.cpu().numpy(),
            "meta": np.asarray([self._chunk, self._npfx]),
        }

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        if not state:
            self.create_index(store, params)
            return
        self.store = store
        self._set_chunk(int(state["meta"][0]))
        self._npfx = int(state["meta"][1])
        self.data = self.space.encode_dataset(store, row_multiple=self._chunk)
        dev = self.data.ids.device
        self._pivot_rows = torch.from_numpy(np.asarray(state["pivot_rows"], np.int32)).to(dev)
        self._prefix = torch.from_numpy(np.asarray(state["prefix"], np.int32)).to(dev)
