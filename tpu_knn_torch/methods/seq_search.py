"""Exact brute-force scan: seq_search / brute_force (counterpart of
tpu_knn/methods/seq_search.py).

Reference: include/method/seqsearch.h, src/method/seqsearch.cc, a
per-object loop. Here it is a blocked scan over the whole query batch,
in one of two routes (:meth:`SeqSearch._plan_knn`):

  * single pass (:func:`_knn_device`): a chunked matmul scan with a
    streaming top-k, for small corpora;
  * two passes (:func:`_knn_device_twopass`): pass 1 keeps only each
    128-row group's min of the distance block (the group-min kernel,
    ops/groupmin.py), a top-(k+2) over the [Q, N/128] mins selects groups
    that provably hold the exact top-k (ops/topk.py GROUP), and pass 2
    gathers those groups' rows and re-scores them exactly.

This method is also the gold-standard generator of the evaluation
harness (gold_standard.h:151-174).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataStore, round_up
from ..core.errors import IndexNotBuiltError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import groupmin as GM
from ..ops.distance import check_precision
from ..ops import topk as T
from ..ops.graph import gather_row_groups, score_gathered
from .base import Method

#: Extra groups pass 2 re-scans beyond k: the f32 pass-1 kernel sums in
#: another order than pass 2, and the margin absorbs that jitter.
_PASS1_MARGIN = 2
#: Queries per pass-2 block: [B, kg*128, D] gathered rows bound memory
#: (805 MB at B=1024, kg=12, D=128 in f32).
_PASS2_QBLK = 1024


def _ids_of(data, pos: torch.Tensor) -> torch.Tensor:
    n_pad = data.ids.shape[0]
    return torch.where(pos >= 0, data.ids[pos.clamp(0, n_pad - 1)].long(), -1)


def _knn_device(space, qenc, data, k: int, chunk: int, precision: str):
    """Single-pass scan: [Q, chunk] blocks merged into a running top-k."""
    nq = qenc["q"].shape[0]
    num_chunks = data.ids.shape[0] // chunk

    def chunk_dists(ci):
        return space.block(qenc, space.slice_data(data, ci * chunk, chunk), precision)

    d, pos = T.streaming_smallest_k(chunk_dists, num_chunks, chunk, nq, k, data.vecs.device)
    return d, _ids_of(data, pos), pos


def _pass1(space, qenc, data) -> torch.Tensor:
    """Group mins f32[Q, N_pad/128] of the affine surrogate distance."""
    aff = space.pass1_affine()
    if aff is None:
        raise NotImplementedError(
            f"two-pass scan of {space.name!r}: only affine-factored spaces are ported (ROADMAP.md)"
        )
    scale, sq, sx = aff
    q = qenc["q"]
    qt = qenc.get("q_term")
    if qt is None or sq == 0.0:
        qt = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    else:
        qt = sq * qt
    xt = data.extra["pad"]
    if data.row_term is not None and sx != 0.0:
        xt = xt + sx * data.row_term
    return GM.fused_groupmin(q, data.vecs, qt, xt, scale)


def _pass2(space, qenc, data, gsel: torch.Tensor, k: int):
    """Gather the selected groups' contiguous rows, re-score exactly,
    in blocks of _PASS2_QBLK queries. Returns ([Q, k] dists, positions)."""
    nq = gsel.shape[0]
    corpus = space.corpus_dict(data)
    dks, poss = [], []
    for b0 in range(0, nq, _PASS2_QBLK):
        b1 = min(b0 + _PASS2_QBLK, nq)
        qe = {key: (v[b0:b1] if v.ndim >= 1 and v.shape[0] == nq else v) for key, v in qenc.items()}
        rows, pad, extras, cols = gather_row_groups(corpus, gsel[b0:b1], T.GROUP)
        d = score_gathered(space, qe, rows, pad, extras)  # [B, kg*128]
        dk, sel = T.smallest_k(d, k)
        dks.append(dk)
        poss.append(torch.gather(cols, 1, sel))
    return torch.cat(dks), torch.cat(poss)


def _knn_device_twopass(space, qenc, data, k: int, precision: str):
    """Two-pass exact scan (f32 pass 1, no certificate).

    Pass 1 runs the fused group-min kernel; one top-(k+2) over the
    [Q, N/128] mins selects groups in lax.top_k's order (ascending min,
    ties by lower group), pass 2 re-scores their rows exactly and takes
    the final top-k. The kernel scans the whole corpus in one launch."""
    check_precision(precision)  # pass 2's batched_dot is f32 only
    n_pad = data.ids.shape[0]
    mins = _pass1(space, qenc, data)
    kg = min(k + _PASS1_MARGIN, n_pad // T.GROUP)
    _, gsel = T.smallest_k(mins, kg)  # [Q, kg] group indices
    dk, pos = _pass2(space, qenc, data, gsel, k)
    pos = torch.where(torch.isinf(dk), -1, pos)
    return dk, _ids_of(data, pos), pos


@register_method("brute_force")  # the reference's PRIMARY registry name
@register_method("seq_search")  # (seqsearch.h:22-23: brute_force, seq_search)
class SeqSearch(Method):
    """Exact kNN scan; the correctness oracle for every ANN method."""

    name = "seq_search"
    supports_range = False  # range search is a later slice (ROADMAP.md)

    DEFAULT_CHUNK = 8192

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        # Reference-parity knobs (seqsearch.cc:52-71): accepted, with the
        # threading ones subsumed by batching.
        self.copy_mem = pm.get("copyMem", False, bool)
        self.multi_thread = pm.get("multiThread", False, bool)
        self.thread_qty = pm.get("threadQty", 0, int)
        self.chunk = pm.get("chunkSize", 0, int)
        self.precision = pm.get("precision", "float32", str)
        # pass-1 precision tiers of tpu_knn; only float32 is ported, the
        # others raise at query time
        self.pass1_precision = pm.get("pass1Precision", "float32", str)
        if self.pass1_precision not in ("float32", "high", "bfloat16"):
            raise ValueError(f"bad pass1Precision {self.pass1_precision!r}")
        pm.check_unused()
        #: route of the last knn call: "twopass" or "single" (a diagnostic)
        self.last_route = None

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        n = max(len(store), 1)
        default = getattr(self.space, "preferred_chunk", self.DEFAULT_CHUNK)
        chunk = self.chunk or min(default, round_up(n, 8))
        chunk = round_up(chunk, 8)
        self.data = self.space.encode_dataset(store, row_multiple=chunk)
        self._chunk = chunk

    def set_query_time_params(self, params: Params | None) -> None:
        pm = ParamManager(Params.of(params))
        pm.get("dummyParam", 0, int)  # parity no-op
        pm.check_unused()
        super().set_query_time_params(params)

    def _plan_knn(self, k: int):
        n_pad = self.data.ids.shape[0]
        kk = min(k, n_pad)
        # the two-pass group-min path pays off once the corpus dwarfs the
        # (k+margin)*128 candidate re-scan; small corpora keep the
        # single-pass merge
        use_twopass = (
            self._chunk % 128 == 0
            and n_pad % 128 == 0
            and n_pad >= 8 * (kk + 2) * 128
        )
        return kk, use_twopass

    def knn(self, points, k: int):
        if self.data is None:
            raise IndexNotBuiltError("seq_search: index not built")
        if self.pass1_precision != "float32":
            raise NotImplementedError(
                f"pass1Precision={self.pass1_precision!r}: the reduced pass-1 tiers and their "
                "certificate are not ported yet (ROADMAP.md, TPU kernels to port)"
            )
        kk, use_twopass = self._plan_knn(k)
        qenc = self.space.encode_queries(points)
        if use_twopass:
            d, ids, _ = _knn_device_twopass(self.space, qenc, self.data, kk, self.precision)
        else:
            d, ids, _ = _knn_device(self.space, qenc, self.data, kk, self._chunk, self.precision)
        self.last_route = "twopass" if use_twopass else "single"
        return self._knn_finish(d, ids, k, kk)

    def _knn_finish(self, d, ids, k: int, kk: int):
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        if kk < k:  # keep the requested width; extras are masked
            padw = k - kk
            d = np.pad(d, ((0, 0), (0, padw)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, padw)), constant_values=-1)
        self.dist_comps += d.shape[0] * self.data.count
        return self._finalize_knn(d, ids)
