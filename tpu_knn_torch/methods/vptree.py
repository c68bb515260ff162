"""VP-tree with the learned "stretched triangle inequality" pruner
(counterpart of tpu_knn/methods/vptree.py; reference:
include/method/vptree.h, src/method/vptree.cc, include/searchoracle.h
PolynomialPruner).

As in tpu_knn, the recursive build is *level-synchronous*: at each depth
every node picks a random pivot, every point is scored against its own
segment's pivot in one device pass, and a median split on the host gives
a balanced implicit binary tree over a corpus permutation, so leaves are
contiguous slices. The host split is tpu_knn's ``np.lexsort`` (stable), so
on the same distances the tree is tpu_knn's.

Search replaces the recursive branch-and-bound with batched phases:
  1. one [Q, n_internal] block for all query-to-pivot distances;
  2. greedy descent to each query's home leaf, a scan of it, and the
     initial radius r (the k-th best);
  3. per-(query, leaf) pruner bounds (searchoracle.h:163-186), a leaf
     being visited when its bound is <= r;
  4. either one masked streaming scan of the corpus over the union of
     visited leaves, or, when ``maxLeavesToVisit`` bounds the visit set
     tightly enough, a gathered pass that scores only each query's
     best-bound leaves' rows.

Phase 3 prunes with the phase-2 radius (>= the reference's evolving
radius), so the visited set is a superset of the reference's.

tpu_knn's jitted functions with static arguments are plain functions here
and its ``lax.scan``s over chunks and gathered steps are host loops over
the same chunks and steps. The gathered route runs in query blocks whose
gathered rows hold at most ``ops/distance.block_elems`` elements (2048
queries x 64 leaves x 64 rows x 128 f32 would be ~4 GB); every query is
scored on its own, so the blocks change no result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataset import DataStore, round_up
from ..core.errors import IndexNotBuiltError
from ..core.params import ParamManager, Params
from ..core.registry import register_method
from ..ops import graph as G
from ..ops import topk as T
from ..ops.distance import block_elems
from ..ops.topk import INF
from ..utils.logging import log
from ..utils.rng import np_rng
from .base import Method, stream_range_results
from .hnsw import _gather_qenc
from .seq_search import _densify, _nq, _slice_qenc


def _gather_xc(space, data, rows: torch.Tensor) -> dict:
    """Corpus slice at arbitrary row indices, in block()'s xc format."""
    c = space.corpus_dict(data)
    r2, pad2, extras2 = G.gather_rows(c, rows[None, :])
    extras2 = G.inject_term(space, r2, extras2)
    xc = {"x": r2[0], "pad": pad2[0]}
    xc.update({k: v[0] for k, v in extras2.items()})
    if "vocab_mark" in c:
        # the vocabulary width rides along ungathered, so sparse blocks
        # against the gathered rows take the densified-table path
        xc["vocab_mark"] = c["vocab_mark"]
    return xc


def _vptree_knn(space, qenc, data, pivot_pos, medians, leaf_members, leaf_of, leaf_count, pruner,
                depth: int, leaf_cap: int, k: int, max_leaves: int, chunk: int, gathered: bool = False):
    """(dists f32[Q, k], ids i32[Q, k], per-query distance counts i32[Q])."""
    n_internal = pivot_pos.shape[0]
    n_leaves = leaf_members.shape[0]
    n_pad = data.ids.shape[0]
    dev = data.ids.device
    # a sparse space's densified query table, once for every scan below
    qenc = _densify(space, qenc, data)
    b = _nq(qenc)

    # phase 1: all query-to-pivot distances in one gathered block
    dpiv = space.block(qenc, _gather_xc(space, data, pivot_pos))  # [Q, n_internal]
    # distance counts are PER QUERY (the batch total can exceed int32 at
    # 2048 queries x 1M; the host sums them in int64)
    ndist = torch.full((b,), n_internal, dtype=torch.int32, device=dev)

    # phase 2: home-leaf descent and the initial radius
    node = torch.ones(b, dtype=torch.long, device=dev)
    for _ in range(depth):
        dq = dpiv.gather(1, node[:, None] - 1)[:, 0]
        node = torch.where(dq <= medians[node - 1], 2 * node, 2 * node + 1)
    home_leaf = node - (n_internal + 1)
    home = leaf_members[home_leaf.clamp(0, n_leaves - 1)]  # [Q, leaf_cap]
    dh = _score_members(space, qenc, data, home)
    ndist = ndist + (home >= 0).sum(dim=1, dtype=torch.int32)
    kk = min(k, leaf_cap)
    init_d, init_pos = T.smallest_k(dh, kk, home.long())
    init_d, init_pos = _pad_k(init_d, init_pos, k)
    # pivots are real points and take part in the results
    piv_d, piv_pos = T.smallest_k(dpiv, min(k, n_internal), pivot_pos.long())
    r = torch.minimum(init_d[:, -1], piv_d[:, -1] if k <= n_internal else torch.full_like(init_d[:, -1], INF))

    # phase 3: per-leaf pruner bounds; the capped paths spend the leaf
    # budget in ascending-bound order (the reference's pruner-guided
    # recursion order, vptree.cc:417-470), not index order
    prio = _vptree_leaf_bounds(dpiv, medians, pruner, depth)
    visit = prio <= r[:, None]

    if gathered:
        # phase 4, gathered: each query scores only its ``max_leaves``
        # best-bound visited leaves' rows, O(Q * max_leaves * leaf_cap)
        key = torch.where(visit, prio, INF)
        # stable: ties (the all-zero-bound home path) keep ascending leaf id
        skey, sid = torch.sort(key, dim=1, stable=True)
        sel = torch.where(skey[:, :max_leaves] < INF, sid[:, :max_leaves], n_leaves)  # n_leaves: no visit
        grp = max(1, min(max_leaves, 4096 // leaf_cap))
        steps = -(-max_leaves // grp)
        if steps * grp > max_leaves:
            sel = torch.cat([sel, sel.new_full((b, steps * grp - max_leaves), n_leaves)], dim=1)
        corpus = space.corpus_dict(data)
        qg = G.densify_queries(space, qenc, corpus)
        cd = torch.full((b, k), INF, dtype=torch.float32, device=dev)
        cpos = torch.full((b, k), -1, dtype=torch.long, device=dev)
        nvis = torch.zeros(b, dtype=torch.int32, device=dev)
        for si in range(steps):
            lf = sel[:, si * grp:(si + 1) * grp]
            ok = lf < n_leaves
            safe = lf.clamp(0, n_leaves - 1)
            rows = torch.where(ok[:, :, None], leaf_members[safe], -1).reshape(b, grp * leaf_cap)
            dly = G.score_rows(space, qg, corpus, rows)
            cd, cpos = T.merge_topk(cd, cpos, dly, rows.long(), k)
            nvis = nvis + torch.where(ok, leaf_count[safe], 0).sum(dim=1, dtype=torch.int32)
        # the home leaf counts in both phases, like the masked path's sum
        ndist = ndist + nvis
    else:
        # maxLeavesToVisit cap in pruner-bound order
        if max_leaves < n_leaves:
            lidx = torch.arange(n_leaves, device=dev).expand(b, n_leaves)
            key = torch.where(visit, prio, INF)
            sid = torch.sort(key, dim=1, stable=True).indices
            rank = torch.empty_like(sid).scatter_(1, sid, lidx)
            visit = visit & (rank < max_leaves)

        # phase 4, masked: a streaming scan over the union of visited leaves,
        # never more than one [Q, chunk] block
        def chunk_dists(ci):
            d, vis = _visited_chunk(space, qenc, data, leaf_of, visit, ci, chunk)
            return torch.where(vis, d, INF)

        cd, cpos = T.streaming_smallest_k(chunk_dists, n_pad // chunk, chunk, b, k, dev)
        ndist = ndist + (visit * leaf_count[None, :]).sum(dim=1, dtype=torch.int32)

    # merge the three result sets; dedup on the whole concatenation before
    # truncating to k (the home leaf is scored in phases 2 and 4)
    md, mpos = _dedup_topk(torch.cat([init_d, piv_d, cd], dim=1), torch.cat([init_pos, piv_pos, cpos], dim=1), k)
    ids = torch.where(mpos >= 0, data.ids[mpos.clamp(0, n_pad - 1)], -1)
    return md, ids, ndist


def _vptree_leaf_bounds(dpiv, medians, pruner, depth: int) -> torch.Tensor:
    """Per-(query, leaf) pruner bound f32[Q, 2^depth]: the smallest ball
    radius that reaches the leaf, the max over its root path of the
    crossing cost a*diff**e at every level where the leaf lies on the far
    side of the median. The visit rule of searchoracle.h:163-186 is exactly
    ``bound <= r``."""
    b = dpiv.shape[0]
    a_l, e_l, a_r, e_r = pruner
    prio = dpiv.new_zeros((b, 1))
    for lvl in range(depth):
        lo, width = (1 << lvl) - 1, 1 << lvl
        dq = dpiv[:, lo:lo + width]
        med = medians[lo:lo + width][None, :]
        diff_l = torch.clamp_min(med - dq, 0.0)
        diff_r = torch.clamp_min(dq - med, 0.0)
        # entering the right child from the left side costs aL*diffL**eL,
        # and vice versa; the containing side costs 0
        cost_r = torch.where(dq <= med, a_l * diff_l ** e_l, 0.0)
        cost_l = torch.where(dq >= med, a_r * diff_r ** e_r, 0.0)
        prio = torch.stack([torch.maximum(prio, cost_l), torch.maximum(prio, cost_r)], dim=2).reshape(b, 2 * width)
    return prio


def _vptree_visit_masks(dpiv, medians, r, pruner, depth: int) -> torch.Tensor:
    """Per-query leaf visit masks for a fixed ball radius ``r`` [Q]: with
    alpha=exp=1 the exact triangle-inequality rule."""
    return _vptree_leaf_bounds(dpiv, medians, pruner, depth) <= r[:, None]


def _range_prelude(space, qenc, data, pivot_pos, medians, pruner, radius: float, depth: int):
    """Shared front of the two range passes: densified queries, the pivot
    distances and the visit masks at the fixed radius."""
    qenc = _densify(space, qenc, data)
    dpiv = space.block(qenc, _gather_xc(space, data, pivot_pos))
    r = torch.full((dpiv.shape[0],), radius, dtype=torch.float32, device=dpiv.device)
    return qenc, dpiv, _vptree_visit_masks(dpiv, medians, r, pruner, depth)


def _visited_chunk(space, qenc, data, leaf_of, visit, ci: int, chunk: int):
    """(distances [Q, chunk] of corpus chunk ``ci``, its visited mask)."""
    n_leaves = visit.shape[1]
    d = space.block(qenc, space.slice_data(data, ci * chunk, chunk))
    lf = leaf_of[ci * chunk:(ci + 1) * chunk]
    vis = visit.gather(1, lf.clamp(0, n_leaves - 1).long()[None, :].expand(d.shape[0], -1)) & (lf >= 0)[None, :]
    return d, vis


def _vptree_range_counts(space, qenc, data, pivot_pos, medians, leaf_of, leaf_count, pruner, radius: float,
                         depth: int, chunk: int):
    """Pruned range pass 1: per-query hit counts (leaves and pivots) and
    per-query distance counts, without materializing [Q, N]."""
    qenc, dpiv, visit = _range_prelude(space, qenc, data, pivot_pos, medians, pruner, radius, depth)
    counts = (dpiv <= radius).sum(dim=1, dtype=torch.int32)
    for ci in range(data.ids.shape[0] // chunk):
        d, vis = _visited_chunk(space, qenc, data, leaf_of, visit, ci, chunk)
        counts += (vis & (d <= radius)).sum(dim=1, dtype=torch.int32)
    ndist = pivot_pos.shape[0] + (visit * leaf_count[None, :]).sum(dim=1, dtype=torch.int32)
    return counts, ndist


def _vptree_range_collect(space, qenc, data, pivot_pos, medians, leaf_of, leaf_count, pruner, radius: float,
                          cap: int, depth: int, chunk: int):
    """Pruned range pass 2: ascending ([Q, cap] dists, corpus positions) of
    every hit; (+inf, -1) past each query's count."""
    qenc, dpiv, visit = _range_prelude(space, qenc, data, pivot_pos, medians, pruner, radius, depth)

    def chunk_dists(ci):
        d, vis = _visited_chunk(space, qenc, data, leaf_of, visit, ci, chunk)
        return torch.where(vis & (d <= radius), d, INF)  # a NaN distance is no hit

    cd, cpos = T.streaming_smallest_k(chunk_dists, data.ids.shape[0] // chunk, chunk, dpiv.shape[0], cap,
                                      data.ids.device, nan_free=True)
    # pivots are real points too (the heap nodes hold them, not the leaves)
    pd, ppos = T.smallest_k(torch.where(dpiv <= radius, dpiv, INF), min(cap, pivot_pos.shape[0]),
                            pivot_pos.long(), nan_free=True)
    ppos = torch.where(torch.isinf(pd), -1, ppos)
    return T.merge_topk(cd, cpos, pd, ppos, cap, nan_free=True)


def _score_members(space, qenc, data, rows):
    """Distances of every query to candidate rows: shared rows i32[C] give
    [Q, C] through one gathered block; rows i32[Q, C] (per query) go
    through ops/graph.score_rows. Rows may be -1 (scored +inf)."""
    if rows.ndim == 1:
        return space.block(qenc, _gather_xc(space, data, rows))
    return G.score_rows(space, qenc, space.corpus_dict(data), rows)


def _dedup_topk(d, pos, k: int):
    """Mask duplicate positions (keep the first occurrence), re-sort."""
    w = d.shape[1]
    dup = (pos[:, :, None] == pos[:, None, :]) & (pos[:, :, None] >= 0)
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=d.device), diagonal=-1)[None]
    is_dup = (dup & earlier).any(dim=2)
    return T.smallest_k(torch.where(is_dup, INF, d), k, torch.where(is_dup, -1, pos))


def _pad_k(d, ids, k: int):
    kk = d.shape[1]
    if kk >= k:
        return d[:, :k], ids[:, :k]
    return (torch.cat([d, d.new_full((d.shape[0], k - kk), INF)], dim=1),
            torch.cat([ids, ids.new_full((ids.shape[0], k - kk), -1)], dim=1))


def _self_pair_dists(space, qenc_all, corpus, q_rows: np.ndarray, x_rows: np.ndarray) -> np.ndarray:
    """d(point q_rows[i], point x_rows[i]) for the level-synchronous build,
    in blocks (tpu_knn's: 2048 pairs for a sparse space, whose score_rows
    densifies a [blk, V] query table, else 65536)."""
    m, n = q_rows.shape[0], corpus["count"]
    blk = 2048 if "vocab_mark" in corpus else 65536
    dev = corpus["vecs"].device
    out = np.zeros(m, np.float32)
    for lo in range(0, m, blk):
        hi = min(lo + blk, m)
        qe = _gather_qenc(qenc_all, torch.from_numpy(q_rows[lo:hi]).to(dev), n)
        xr = torch.from_numpy(x_rows[lo:hi].astype(np.int32)).to(dev)
        out[lo:hi] = G.score_rows(space, qe, corpus, xr[:, None])[:, 0].cpu().numpy()
    return out


@register_method("vptree")
class VPTree(Method):
    name = "vptree"
    supports_range = True

    def __init__(self, space, params: Params | None = None):
        super().__init__(space, params)
        pm = ParamManager(self.index_params)
        self.bucket_size = pm.get("bucketSize", 50, int)
        pm.get("chunkBucket", True, bool)  # parity no-op: the layout is contiguous
        pm.get("selectPivotAttempts", 5, int)  # parity no-op: a random pivot
        self.seed = pm.get("seed", 0, int)
        # index-time tuning triggers (reference: vptree.cc + tune.h)
        self.desired_recall = pm.get("desiredRecall", 0.0, float)
        self.tune_k = pm.get("tuneK", 0, int)
        self.tune_r = pm.get("tuneR", 0.0, float)
        self.tune_qty = pm.get("tuneQty", 200, int)
        # exponent grid of the autotuner (searchoracle.cc:212, defaults 1/1)
        self.min_exp = pm.get("minExp", 1, int)
        self.max_exp = pm.get("maxExp", 1, int)
        if self.max_exp < self.min_exp or self.max_exp < 1:
            raise ValueError("maxExp must be >= minExp >= 1")
        pm.check_unused()
        # query-time pruner parameters (searchoracle.h defaults: all 1)
        self.alpha_left = 1.0
        self.exp_left = 1.0
        self.alpha_right = 1.0
        self.exp_right = 1.0
        self.max_leaves = 1 << 30
        #: route a finite maxLeavesToVisit through the gathered traversal
        #: (phase 4 of _vptree_knn) instead of the masked corpus scan
        self.gather_traversal = True
        self._tree = None

    def set_query_time_params(self, params: Params | None) -> None:
        if params is None:
            # ResetQueryTimeParams: the pruner defaults are all 1 (searchoracle.h)
            self.alpha_left = self.alpha_right = 1.0
            self.exp_left = self.exp_right = 1.0
            self.max_leaves = 1 << 30
            super().set_query_time_params(None)
            return
        pm = ParamManager(Params.of(params))
        self.alpha_left = pm.get("alphaLeft", self.alpha_left, float)
        self.alpha_right = pm.get("alphaRight", self.alpha_right, float)
        self.exp_left = pm.get("expLeft", self.exp_left, float)
        self.exp_right = pm.get("expRight", self.exp_right, float)
        self.max_leaves = pm.get("maxLeavesToVisit", self.max_leaves, int)
        pm.check_unused()
        super().set_query_time_params(params)

    # ---------------- construction ----------------

    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        self.store = store
        n = len(store)
        pref = getattr(self.space, "preferred_chunk", 8192)
        chunk = round_up(max(8, min(pref, round_up(max(n, 1), 8))), 8)
        self._chunk = chunk
        self.data = self.space.encode_dataset(store, row_multiple=chunk)
        if n == 0:
            self._tree = None
            return
        rng = np_rng(self.seed)
        # depth so that a leaf holds <= bucket_size points (pivots removed)
        depth = 0
        while (n >> depth) > self.bucket_size and (1 << depth) <= n:
            depth += 1
        self.depth = depth
        n_internal = (1 << depth) - 1
        n_leaves = 1 << depth

        # every level: one device pass scoring each active point against
        # its own segment's pivot, then a vectorized lexsort / median /
        # split on the host (reference semantics, vptree.cc:69-105: a random
        # pivot, a median split, the pivot removed from the pool)
        qenc_all = self.space.encode_queries(self.space.store_as_query_points(store))
        corpus = self.space.corpus_dict(self.data)
        perm = np.arange(n, dtype=np.int64)  # active points, segment-contiguous
        seg = np.zeros(n, np.int64)  # segment of each active point
        pivot_pos = np.zeros(n_internal, np.int32)
        medians = np.zeros(n_internal, np.float32)
        node_base = 0
        for lvl in range(depth):
            width = 1 << lvl
            m = perm.shape[0]
            seg_len = np.bincount(seg, minlength=width)[:width]
            seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
            nz = seg_len > 0
            off = rng.integers(0, np.maximum(seg_len, 1))
            pidx = seg_start + np.minimum(off, np.maximum(seg_len - 1, 0))
            piv_pts = np.zeros(width, np.int64)
            if m:
                piv_pts[nz] = perm[np.minimum(pidx, m - 1)][nz]
            pivot_pos[node_base:node_base + width] = piv_pts
            keep = np.ones(m, bool)
            if m:
                keep[pidx[nz]] = False  # the pivots move into the nodes
            perm, seg = perm[keep], seg[keep]
            d = _self_pair_dists(self.space, qenc_all, corpus, perm, piv_pts[seg])
            order = np.lexsort((d, seg))  # segment-major, distance-minor, stable
            perm, seg, d = perm[order], seg[order], d[order]
            seg_len2 = np.bincount(seg, minlength=width)[:width]
            seg_start2 = np.concatenate([[0], np.cumsum(seg_len2)[:-1]])
            half = seg_len2 // 2
            last = seg_start2 + np.maximum(seg_len2 - 1, 0)
            i1 = seg_start2 + np.maximum(half - 1, 0)
            i2 = seg_start2 + np.minimum(half, np.maximum(seg_len2 - 1, 0))
            take = lambda idx: d.take(np.minimum(idx, max(d.shape[0] - 1, 0)))  # noqa: E731
            med = np.where(
                (half > 0) & (half < seg_len2),
                (take(i1) + take(i2)) / 2.0,
                np.where(seg_len2 > 0, take(last), 0.0),
            )
            medians[node_base:node_base + width] = med.astype(np.float32)
            pos_in_seg = np.arange(perm.shape[0], dtype=np.int64) - seg_start2[seg]
            seg = 2 * seg + (pos_in_seg >= half[seg])
            node_base += width
        # pack the leaves (the final segments)
        seg_len = np.bincount(seg, minlength=n_leaves)[:n_leaves]
        seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
        leaf_cap = round_up(max(int(seg_len.max(initial=1)), 1), 8)
        leaf_members = np.full((n_leaves, leaf_cap), -1, np.int32)
        leaf_of = np.full(self.data.ids.shape[0], -1, np.int32)  # -1: pivots and padding
        pos_in_seg = np.arange(perm.shape[0], dtype=np.int64) - seg_start[seg]
        leaf_members[seg, pos_in_seg] = perm
        leaf_of[perm] = seg
        self._set_tree({"pivot_pos": pivot_pos, "medians": medians, "leaf_members": leaf_members,
                        "leaf_of": leaf_of, "leaf_count": seg_len.astype(np.int32)})
        self.leaf_cap = leaf_cap
        log("DEBUG", f"vptree built: n={n} depth={depth} leaf_cap={leaf_cap}")
        if self.desired_recall > 0:
            self._autotune(store)

    def _set_tree(self, arrays: dict) -> None:
        dev = self.data.ids.device
        self._tree = {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(dev)
                      for k in ("pivot_pos", "medians", "leaf_members", "leaf_of", "leaf_count")}

    def _autotune(self, store: DataStore) -> None:
        """GetOptimalAlphas analog (reference: include/tune.h, vptree.cc):
        the largest alpha (fewest visits) whose recall on a sampled query
        set still meets desiredRecall."""
        from ..eval.tune import tune_vptree_alphas

        k = self.tune_k if self.tune_k > 0 else 10
        res = tune_vptree_alphas(self, store, k=k, desired_recall=self.desired_recall,
                                 sample=min(self.tune_qty, len(store)),
                                 exp_grid=list(range(self.min_exp, self.max_exp + 1)))
        self.alpha_left = res["alphaLeft"]
        self.alpha_right = res["alphaRight"]
        self.exp_left = res.get("expLeft", self.exp_left)
        self.exp_right = res.get("expRight", self.exp_right)
        log("INFO", f"vptree autotune: {res}")

    # ---------------- search ----------------

    def _pruner(self) -> tuple:
        return (self.alpha_left, self.exp_left, self.alpha_right, self.exp_right)

    def _gathered_qblk(self, ml: int) -> int:
        """Queries a block of the gathered route: its gathered rows (a step's
        leaves x leaf_cap rows of the corpus row width) within block_elems."""
        vecs = self.space.corpus_dict(self.data)["vecs"]
        per_query = min(ml, max(1, 4096 // self.leaf_cap)) * self.leaf_cap * max(vecs[0].numel(), 1)
        return max(1, block_elems(vecs.device) // per_query)

    def knn(self, points, k: int):
        if self._tree is None:
            raise IndexNotBuiltError("vptree: index not built")
        qenc = self.space.encode_queries(points)
        t = self._tree
        if t["pivot_pos"].shape[0] == 0:
            # degenerate: a single leaf, an exact scan of its members
            members = t["leaf_members"][0]
            d = _score_members(self.space, qenc, self.data, members)
            dd, pos = T.smallest_k(d, min(k, d.shape[1]), members.long())
            ids = torch.where(pos >= 0, self.data.ids[pos.clamp(0, self.data.ids.shape[0] - 1)], -1)
            # every member is scored per query (as in range's degenerate branch)
            self._add_dist_comps(d.shape[0] * int((members >= 0).sum()))
            dd, ids = _pad_k(dd, ids, k)
            return self._finalize_knn(dd.cpu().numpy(), ids.cpu().numpy())
        n_leaves = t["leaf_members"].shape[0]
        ml = min(self.max_leaves, n_leaves)
        # a finite maxLeavesToVisit bounds the work a query does: the
        # gathered traversal replaces the masked scan, unless the cap is so
        # loose that gathering would touch more rows than the scan reads
        gathered = (self.gather_traversal and 1 <= ml < n_leaves
                    and ml * self.leaf_cap * 4 <= self.data.ids.shape[0])
        args = (t["pivot_pos"], t["medians"], t["leaf_members"], t["leaf_of"], t["leaf_count"], self._pruner(),
                self.depth, self.leaf_cap, k, ml, self._chunk)
        nq = _nq(qenc)
        qblk = self._gathered_qblk(ml) if gathered else max(nq, 1)
        outs = [_vptree_knn(self.space, _slice_qenc(qenc, nq, b0, min(b0 + qblk, nq)), self.data, *args,
                            gathered=gathered) for b0 in range(0, nq, qblk)]
        d, ids, nd = (torch.cat(parts) for parts in zip(*outs))
        self._add_dist_comps(nd)
        return self._finalize_knn(d.cpu().numpy(), ids.cpu().numpy())

    def range(self, points, radius: float):
        """Pruned range query (reference: vptree.cc:417-470 GenericSearch
        with RangeQuery): the kNN visit rule at a fixed ball radius prunes
        whole subtrees (exact at the default alpha=1 pruner, approximate
        beyond), and hits stream through a running smallest-cap merge, so
        device memory stays O(Q*(cap+chunk)), never [Q, N]."""
        if self._tree is None:
            raise IndexNotBuiltError("vptree: index not built")
        t = self._tree
        if t["pivot_pos"].shape[0] == 0:
            # degenerate single-leaf tree: the streamed exact scan
            from .seq_search import SeqSearch

            tmp = SeqSearch(self.space, Params())
            tmp.data, tmp._chunk = self.data, self._chunk
            out = tmp.range(points, radius)
            self.dist_comps += tmp.dist_comps
            return out
        qenc = self.space.encode_queries(points)
        args = (self.space, qenc, self.data, t["pivot_pos"], t["medians"], t["leaf_of"], t["leaf_count"],
                self._pruner(), float(radius))
        counts, nd = _vptree_range_counts(*args, self.depth, self._chunk)
        self._add_dist_comps(nd)
        return stream_range_results(counts.cpu().numpy(), self.data,
                                    lambda cap: _vptree_range_collect(*args, cap, self.depth, self._chunk))

    # ---------------- persistence ----------------

    def state_arrays(self) -> dict:
        if self._tree is None:
            return {}
        out = {key: v.cpu().numpy() for key, v in self._tree.items()}
        out["meta"] = np.asarray([self.depth, self.leaf_cap, self.bucket_size, self._chunk])
        return out

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        if not state:
            self.create_index(store, params)
            return
        self.store = store
        self._chunk = int(state["meta"][3])
        self.data = self.space.encode_dataset(store, row_multiple=self._chunk)
        self._set_tree(state)
        self.depth = int(state["meta"][0])
        self.leaf_cap = int(state["meta"][1])
