"""Corpus-sharded exact search (counterpart of tpu_knn/parallel/sharded.py;
the reference's thread-sharded scan + merge, seqsearch.cc:73-98, 163-176).

The corpus is encoded once (``row_multiple = 8 * S``) and split into S
equal row blocks, shard ``si`` on ``mesh.device(si)``; queries are
replicated. Each shard is a row slice of the encoded corpus of the same
layout (:func:`shard_data`): every row-indexed tensor is sliced, the
explicit ``pad`` (and the row term) with it, the count becomes the
shard's own, and a table that is not row-indexed (a sparse corpus's
``vocab_mark``) is replicated whole, never split.

Each shard runs the port's own exact scan over its rows (methods/
seq_search.py): for a space with an affine factored form at the f32 tier,
the two-pass route, whose pass 1 is one ``groupmin_f32`` launch over the
shard; otherwise the chunked ``space.block`` scan with a running top-k.
tpu_knn scores one [Q, N/S] ``block`` per shard instead; both give each
shard's top-k ordered by (distance, row), the two-pass route because its
pass 2 gathers the selected groups in ascending row order. The [Q, k]
results then merge shard-major on ``mesh.device(0)`` with one stable
``smallest_k`` over [Q, S*k], as tpu_knn's all_gather + top-k, so equal
distances keep the lower row. The two-tier merge goes over each ICI row
first, then across DCN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.dataset import round_up
from ..core.errors import IndexNotBuiltError, RuntimeNmsError
from ..core.params import ParamManager, Params
from ..methods import seq_search as SS
from ..methods.base import RESULT_DIST_CUTOFF, Method
from ..ops import topk as T
from ..ops.sparse import PAD_X
from ..spaces.dense import PAD_TERM
from .mesh import Mesh

#: rows of the block scan's chunk when the space names none (SeqSearch's)
_DEFAULT_CHUNK = SS.SeqSearch.DEFAULT_CHUNK


def _fill(name: str):
    """Padding value of a row-indexed tensor of an encoded corpus."""
    if name == "ids":
        return -1
    if name in ("pad", "row_mask"):
        return PAD_TERM
    if name == "col":
        return PAD_X
    return 0


def _rows(a, lo: int, n: int, rows: int, fill, dev):
    out = a[lo:lo + n].to(dev)
    if rows == n:
        return out
    tail = torch.full((rows - n,) + tuple(out.shape[1:]), fill, dtype=out.dtype, device=dev)
    return torch.cat([out, tail])


def shard_data(data, lo: int, n: int, rows: int, dev: torch.device):
    """Rows [lo, lo + n) of an encoded corpus as a corpus of the same class
    on ``dev``, padded to ``rows`` rows with each tensor's padding value.
    ``vocab_mark`` and every tensor that is not row-indexed go whole."""
    n_pad = data.ids.shape[0]

    def take(name, a):
        if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == n_pad and name != "vocab_mark":
            return _rows(a, lo, n, rows, _fill(name), dev)
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    fields = {f.name: take(f.name, getattr(data, f.name)) for f in dataclasses.fields(data)
              if f.name not in ("extra", "count")}
    return dataclasses.replace(
        data, **fields, count=max(0, min(int(data.count) - lo, n)),
        extra={k: take(k, v) for k, v in data.extra.items()},
    )


def qenc_to(qenc: dict, dev: torch.device) -> dict:
    """An encoded query batch on ``dev`` (replicated queries)."""
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in qenc.items()}


class ShardedData:
    """The shards of one encoded corpus: ``shards[si]`` on the mesh's
    device ``si``, each ``n_local`` rows of the corpus padded to a multiple
    of its scan ``chunk``. ``count`` and ``n_pad`` are the whole corpus's."""

    def __init__(self, space, data, mesh: Mesh):
        s = mesh.size
        self.n_pad = int(data.ids.shape[0])
        if self.n_pad % s:
            raise ValueError(f"{self.n_pad} encoded rows do not split over {s} shards")
        self.count = int(data.count)
        self.n_local = self.n_pad // s
        chunk = min(getattr(space, "preferred_chunk", _DEFAULT_CHUNK), round_up(self.n_local, 8))
        self.chunk = round_up(chunk, 8)
        rows = round_up(self.n_local, self.chunk)
        self.shards = [shard_data(data, si * self.n_local, self.n_local, rows, mesh.device(si))
                       for si in range(s)]

    def tensors(self):
        """Every tensor of every shard (memory accounting)."""
        return [t for sh in self.shards for t in sh.tensors()]


def _as_sharded(space, data, mesh: Mesh) -> ShardedData:
    return data if isinstance(data, ShardedData) else ShardedData(space, data, mesh)


def _pad_k(dk, ids, k: int):
    """Widen [Q, kk] results to k with (+inf, -1)."""
    if dk.shape[1] < k:
        w = k - dk.shape[1]
        dk = torch.cat([dk, dk.new_full((dk.shape[0], w), T.INF)], dim=1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], w), -1)], dim=1)
    return dk, ids


def _twopass_ok(space, shard, chunk: int, kk: int, precision: str) -> bool:
    """SeqSearch._plan_knn's rule for one shard, at the f32 tier only (the
    kernel and pass 2 run in f32; another ``precision`` is the block
    scan's)."""
    rows = shard.ids.shape[0]
    return (
        precision == "float32"
        and getattr(space, "twopass_ok", True)
        and space.pass1_affine() is not None
        and chunk % T.GROUP == 0
        and rows % T.GROUP == 0
        and rows >= 8 * (kk + 2) * T.GROUP
    )


def _local_exact_knn(space, qenc, shard, k: int, n_local: int, chunk: int, precision: str):
    """Top-k over one shard, ordered by (distance, row). A shard may hold
    fewer than k rows (k <= corpus size is legitimate while k > n/S): the
    local top-k clamps to the shard and pads to k with (+inf, -1) so the
    merge sees uniform widths. Returns ([Q, k] dists, object ids, route)."""
    kk = min(k, n_local)
    if _twopass_ok(space, shard, chunk, kk, precision):
        gsel = SS._select_groups(SS._pass1(space, qenc, shard), kk)
        # ascending groups: pass 2's stable top-k then keeps the lower row
        # among equal distances, as one smallest_k over the shard's block
        dk, pos = SS._pass2(space, qenc, shard, torch.sort(gsel, dim=1).values, kk)
        route = "twopass"
    else:
        dk, _, pos = SS._knn_device(space, qenc, shard, kk, chunk, precision)
        route = "block"
    ids = SS._ids_of(shard, torch.where(torch.isinf(dk), -1, pos))
    dk, ids = _pad_k(dk, ids, k)
    return dk, ids, route


def merge_sharded_topk(dists: list, ids: list, k: int, device=None):
    """Merge per-shard [Q, kk] results: concatenated shard-major on
    ``device`` (the first shard's by default), then one stable
    ``smallest_k`` over [Q, S*kk] with the ids carried."""
    dev = dists[0].device if device is None else device
    md = torch.cat([d.to(dev) for d in dists], dim=1)
    mi = torch.cat([i.to(dev) for i in ids], dim=1)
    return T.smallest_k(md, k, mi)


def _local_results(space, qenc, sd: ShardedData, k: int, mesh: Mesh, precision: str):
    """Every shard's [Q, k] top-k: (dists list, ids list, routes list)."""
    out = [_local_exact_knn(space, qenc_to(qenc, mesh.device(si)), shard, k, sd.n_local, sd.chunk, precision)
           for si, shard in enumerate(sd.shards)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def _sharded_knn(space, qenc, sd: ShardedData, k: int, mesh: Mesh, precision: str):
    """The flat merge of every shard's top-k: (dists, ids, routes)."""
    dks, idss, routes = _local_results(space, qenc, sd, k, mesh, precision)
    return (*merge_sharded_topk(dks, idss, k, mesh.device(0)), routes)


def sharded_exact_knn(space, qenc: dict, data, k: int, mesh: Mesh, precision: str = "float32"):
    """Exact kNN with the corpus sharded across ``mesh``, for every space.
    ``data``: the encoded corpus (encode with ``row_multiple = 8 *
    mesh.size``) or its :class:`ShardedData`. Returns (dists[Q, k],
    ids[Q, k]) on the first shard's device."""
    return _sharded_knn(space, qenc, _as_sharded(space, data, mesh), k, mesh, precision)[:2]


def sharded_exact_knn_hier(space, qenc: dict, data, k: int, mesh: Mesh, precision: str = "float32"):
    """Exact kNN over a two-tier [dcn, ici] mesh (mesh.make_mesh2): the
    corpus is row-sharded over both axes jointly (row-major), the per-shard
    top-k merges first within each ICI row, on the row's first device, then
    across DCN, which so carries only [Q, k] per row. Exactness is
    unchanged: the top-k merge is associative."""
    dcn, ici = mesh.devices.shape
    dks, idss, _ = _local_results(space, qenc, _as_sharded(space, data, mesh), k, mesh, precision)
    rows = [merge_sharded_topk(dks[r * ici:(r + 1) * ici], idss[r * ici:(r + 1) * ici], k, mesh.devices[r, 0])
            for r in range(dcn)]
    return merge_sharded_topk([d for d, _ in rows], [i for _, i in rows], k, mesh.device(0))


def sharded_range(space, qenc: dict, data, radius: float, mesh: Mesh, precision: str = "float32"):
    """Exact range search with the corpus sharded across ``mesh``
    (reference: seqsearch.cc:109-141 scan, :128-139 per-thread merge). Two
    passes, as the single-device streamed scan: per-shard hit counts,
    summed; then a collect pass sized by the largest count, each shard's
    ascending hits within the radius merged like kNN. Returns (counts[Q]
    host, dists[Q, cap], ids[Q, cap]) with (+inf, -1) past each query's
    count; (counts, None, None) when nothing is in range."""
    sd = _as_sharded(space, data, mesh)
    dev0 = mesh.device(0)
    radius = float(radius)
    counts = None
    for si, shard in enumerate(sd.shards):
        c = SS._range_counts_device(space, qenc_to(qenc, mesh.device(si)), shard, radius, sd.chunk,
                                    precision).to(dev0)
        counts = c if counts is None else counts + c
    counts = counts.cpu().numpy()
    if counts.max(initial=0) == 0:
        return counts, None, None
    cap = min(round_up(int(counts.max()), 128), sd.n_pad)
    kk = min(cap, sd.n_local)
    dks, idss = [], []
    for si, shard in enumerate(sd.shards):
        dk, pos = SS._range_collect_device(space, qenc_to(qenc, mesh.device(si)), shard, radius, kk, sd.chunk,
                                           precision)
        dk, ids = _pad_k(dk, SS._ids_of(shard, pos), cap)
        dks.append(dk)
        idss.append(ids)
    dk, ids = merge_sharded_topk(dks, idss, cap, dev0)
    return counts, dk, ids


class DistributedSeqSearch(Method):
    """The sharded exact scan behind ``Index(..., method="seq_search",
    mesh=...)`` (also ``brute_force``): rows sharded over the mesh,
    queries replicated, the per-shard top-k merged on the first shard's
    device."""

    name = "seq_search"
    supports_range = True
    supports_incremental = False
    progress = False

    def __init__(self, space, mesh: Mesh, index_params=None):
        super().__init__(space, index_params)
        self.mesh = mesh
        pm = ParamManager(Params.of(index_params))
        self.precision = pm.get("precision", "float32", str)
        pm.check_unused()
        self.graph = None
        #: per-shard routes of the last knn call ("twopass" or "block")
        self.last_routes: list[str] = []

    def create_index(self, store, params=None) -> None:
        self.store = store
        # rows divisible by the mesh and each shard slice 8-row aligned
        full = self.space.encode_dataset(store, row_multiple=8 * self.mesh.size)
        self.data = ShardedData(self.space, full, self.mesh)

    def set_query_time_params(self, params) -> None:
        pass  # the exact scan has no query-time knobs

    def knn(self, points, k: int):
        if self.data is None:
            raise IndexNotBuiltError("seq_search: index not built")
        qenc = self.space.encode_queries(points)
        kk = min(k, self.data.count) if self.data.count else k
        d, ids, self.last_routes = _sharded_knn(self.space, qenc, self.data, max(kk, 1), self.mesh, self.precision)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        if kk < k:
            d = np.pad(d, ((0, 0), (0, k - kk)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        self._add_dist_comps(d.shape[0] * self.data.count)
        bad = ~np.isfinite(d) | (d >= RESULT_DIST_CUTOFF)
        return np.where(bad, np.inf, d), np.where(bad, -1, ids)

    def range(self, points, radius: float):
        """Sharded exact range scan with the single-device scan's
        [(ids, dists)] contract."""
        if self.data is None:
            raise IndexNotBuiltError("seq_search: index not built")
        qenc = self.space.encode_queries(points)
        counts, dk, ids = sharded_range(self.space, qenc, self.data, radius, self.mesh, self.precision)
        self._add_dist_comps(counts.shape[0] * self.data.count)
        if dk is None:
            return [(np.zeros(0, np.int32), np.zeros(0, np.float32)) for _ in range(counts.shape[0])]
        dk, ids = dk.cpu().numpy(), ids.cpu().numpy()
        return [(ids[i, :c].copy(), dk[i, :c].copy()) for i, c in enumerate(counts)]

    def add_batch(self, store, new_positions):
        raise RuntimeNmsError("distributed seq_search does not support incremental addition")

    def delete_batch(self, positions, strategy="none"):
        raise RuntimeNmsError("distributed seq_search does not support deletion")
