"""Batched graph-search primitives (counterpart of tpu_knn/ops/graph.py):
the gather-and-score helpers of the exact scan's pass 2 and the HNSW
traversal.

Reference hot paths: greedy 1-NN descent through upper levels
(hnsw.cc:547-576) and the ef-bounded best-first beam at level 0
(hnsw.cc:611-708). There, one query walks pointers and scores one
neighbour at a time. Here a whole *batch* of queries advances in lock
step: each iteration expands the EXPAND closest unexpanded beam entries
per query at once, gathers their adjacency rows, scores the whole
[B, EXPAND*M] candidate frontier with one batched product and merges it
into the beam with sorts. Visited tracking is replaced by
dedup-against-beam; re-scoring a dropped node is allowed, re-expansion is
not (a re-inserted node re-enters the beam only by beating the ef-th
distance).

Everything is plain torch ops on an explicit device. What differs from
tpu_knn, with identical results:

  * the beam is carried at width max(ef, expand), not at a multiple of
    128 lanes (a TPU layout choice);
  * duplicates are removed on ids alone (stable sort by id, mask runs,
    stable sort by distance) where tpu_knn sorts on the (distance, id) key
    pair and compares neighbours. Both keep the beam's copy of a node and
    order equal distances by id; tpu_knn's form needs a node to score
    bitwise the same wherever it sits in the candidate block, which a
    batched product on a GPU does not promise, this form does not;
  * the loops run on the host: ``any(active)`` is computed on the device
    and read once per iteration, one device-to-host sync, and the loop
    ends where ``lax.while_loop`` ends, so ``ndist`` is equal. The loops
    are bound by the host's launch rate, so the sync waits for little; a
    form that synced every few iterations and masked the body past the
    end measured slower on an H100 (PERF.md).

Every sort is stable and ties go to the lowest index (``lax.sort``,
``jnp.argsort``, ``lax.top_k`` and ``jnp.argmin`` all do): never
``torch.topk``. ``lax.sort`` puts -0.0 before +0.0 where torch treats
them as equal; no ported space returns -0.0 distances except negdotprod
on exactly orthogonal rows.

A space with no affine form (L1, Jensen-Shannon, Renyi, ...) is scored
per query: ``space.block`` of one query against its own gathered rows,
vmapped over the batch (:func:`score_gathered`), as tpu_knn's ``jax.vmap``
does. The batch runs in row blocks whose intermediates hold at most
ops/distance.block_elems elements; every row is scored alone, so the
blocks change no result. The sparse scorer comes with the sparse spaces.
"""

from __future__ import annotations

import torch

from . import topk as T
from .distance import batched_dot, block_elems
from .topk import INF

#: Host-side counts of the loops: iterations run and device-to-host syncs
#: made, for the beam and for the greedy descent.
counters = {"beam_iters": 0, "beam_syncs": 0, "descent_steps": 0, "descent_syncs": 0}


def reset_counters() -> None:
    for key in counters:
        counters[key] = 0


def qenc_axes(qenc: dict, batch: int, ndim: int = 1) -> dict:
    """vmap in_dims of an encoded query dict: 0 for entries batched along
    their first axis (of at least ``ndim`` dims), None for the rest (0-d
    constants such as Itakura-Saito's ``_dim``)."""
    return {k: (0 if v.ndim >= ndim and v.shape[0] == batch else None) for k, v in qenc.items()}


def vmap_blocks(one, qenc: dict, axes: dict, batched: tuple, per_row: int) -> torch.Tensor:
    """``torch.vmap(one)`` over the leading axis of ``batched`` (tensors and
    dicts of tensors) and of the entries of ``qenc`` that ``axes`` marks 0,
    in row blocks of at most ``block_elems / per_row`` rows; results
    concatenated along the batch."""
    first = batched[0]
    b = first.shape[0]
    dims = (axes,) + tuple({k: 0 for k in t} if isinstance(t, dict) else 0 for t in batched)
    fn = torch.vmap(one, in_dims=dims)
    step = max(1, block_elems(first.device) // max(per_row, 1))

    def sl(t, b0, b1):
        return {k: v[b0:b1] for k, v in t.items()} if isinstance(t, dict) else t[b0:b1]

    outs = []
    for b0 in range(0, b, step):
        b1 = min(b0 + step, b)
        qe = {k: (v[b0:b1] if axes[k] == 0 else v) for k, v in qenc.items()}
        outs.append(fn(qe, *(sl(t, b0, b1) for t in batched)))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _row_pad(corpus: dict, ids: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """Row mask f32 like ``ids`` (+inf on padding and on ids < 0), without
    a gather: padding rows are exactly rows >= the real count. A gathered
    'row_mask' is used only when a method masks real rows dynamically.
    f32 whatever the rows' dtype: an int8 row cannot hold +inf."""
    if "row_mask" in corpus:
        pad = corpus["row_mask"][safe]
    elif "count" in corpus:
        pad = torch.where(ids >= corpus["count"], INF, 0.0).to(torch.float32)
    else:
        pad = corpus["pad"][safe]
    return pad + torch.where(ids < 0, INF, 0.0).to(torch.float32)


def gather_rows(corpus: dict, ids: torch.Tensor):
    """Per-query row gather: (rows [B,K,D], pad [B,K], extras)."""
    safe = ids.clamp(0, corpus["vecs"].shape[0] - 1)
    rows = corpus["vecs"][safe]  # [B, K, D]
    pad = _row_pad(corpus, ids, safe)  # [B, K]
    extra_sl = {}
    if corpus.get("term") is not None:
        extra_sl["x_term"] = corpus["term"][safe]
    return rows, pad, extra_sl


def gather_row_groups(corpus: dict, gsel: torch.Tensor, group: int = 128):
    """Per-query *group* gather: gsel [B, KG] indexes contiguous
    ``group``-row blocks, so each gathered granule is group*rowbytes of
    sequential memory (64KB for f32[128,128] rows) instead of one row.
    Padding rows are positions >= corpus["count"]. Returns (rows
    [B, KG*group, D], pad [B, KG*group], extras, cols [B, KG*group]
    corpus positions)."""
    b, kg = gsel.shape
    gsel = gsel.long()

    def expand(arr):
        g = arr.view((arr.shape[0] // group, group) + tuple(arr.shape[1:]))
        out = g[gsel]  # [B, KG, group, ...]
        return out.reshape((b, kg * group) + tuple(arr.shape[1:]))

    rows = expand(corpus["vecs"])
    cols = gsel[:, :, None] * group + torch.arange(group, device=gsel.device)[None, None, :]
    cols = cols.reshape(b, kg * group)
    # f32 whatever the rows' dtype: an int8 row block (l2sqr_sift) cannot hold +inf
    pad = torch.where(cols >= corpus["count"], INF, 0.0).to(torch.float32)
    extra_sl = {}
    if corpus.get("term") is not None:
        extra_sl["x_term"] = expand(corpus["term"])
    return rows, pad, extra_sl, cols


def inject_term(space, rows, extra_sl: dict) -> dict:
    """Recompute the per-row term from gathered rows when the space can
    (term_from_rows): avoids a separate term gather."""
    if "x_term" not in extra_sl and getattr(space, "term_recompute", False):
        t = space.term_from_rows(rows)
        if t is not None:
            extra_sl = dict(extra_sl)
            extra_sl["x_term"] = t
    return extra_sl


def score_gathered(space, qenc: dict, rows, pad, extra_sl: dict) -> torch.Tensor:
    """Distances of query b to its pre-gathered candidate rows [B,K,D].

    Spaces with an affine factored form (space.pass1_affine) take one
    batched f32 matmul (exact for int8 rows, ops/distance.batched_dot) +
    the exact post-transform. Any other space runs ``space.block`` of each
    query against its own K rows, vmapped over the batch (never a query
    against another query's rows)."""
    extra_sl = inject_term(space, rows, extra_sl)
    aff = space.pass1_affine() if hasattr(space, "pass1_affine") else None
    if aff is not None and rows.ndim == 3:
        scale, sq, sx = aff
        g = batched_dot(qenc["q"], rows)
        s = scale * g
        if sq != 0.0 and "q_term" in qenc:
            s = s + sq * qenc["q_term"][:, None]
        if sx != 0.0 and "x_term" in extra_sl:
            s = s + sx * extra_sl["x_term"]
        return space.pass1_post(s, qenc) + pad

    b, kc = rows.shape[0], rows.shape[1]
    if b == 0:
        return torch.zeros((0, kc), dtype=torch.float32, device=rows.device)
    axes = qenc_axes(qenc, b)

    def one(qe, r, p, ex):
        # restore the (length-1) query axis that vmap strips
        qe = {k: (v[None] if axes[k] == 0 else v) for k, v in qe.items()}
        return space.block(qe, {"x": r, "pad": p, **ex})[0]

    return vmap_blocks(one, qenc, axes, (rows, pad, extra_sl), rows[0].numel())


def score_rows(space, qenc: dict, corpus: dict, ids: torch.Tensor) -> torch.Tensor:
    """Distances between query b and its own gathered candidate rows.

    ids: i32[B, K] corpus row indices (may be -1 / padding; those score +INF).
    corpus: {'vecs': [N,D], 'count': n, optional 'term': [N]}.
    Returns f32[B, K]."""
    rows, pad, extra_sl = gather_rows(corpus, ids)
    d = score_gathered(space, qenc, rows, pad, extra_sl)
    return torch.where(ids < 0, INF, d)


def greedy_descent(
    space,
    qenc: dict,
    corpus: dict,
    adj: torch.Tensor,  # i32[S, M] adjacency for this level (slot-indexed)
    slot_of,  # i32[N] corpus idx -> slot, or None when slot == idx
    start: torch.Tensor,  # i32[B] current node per query (corpus idx)
    start_d: torch.Tensor,  # f32[B]
    max_steps: int = 64,
):
    """Greedy 1-NN walk on one upper level (reference: hnsw.cc:547-576).
    Per step: gather the current node's M neighbours, score, move to the
    best if it improves; stop when no query improves. The step runs for
    every query while any one moved in the step before, as in tpu_knn."""
    cur, cur_d = start, start_d
    for _ in range(max_steps):
        counters["descent_steps"] += 1
        if slot_of is None:
            slots = cur
        else:
            slots = slot_of[cur.clamp(0, slot_of.shape[0] - 1)]
        nbrs = adj[slots.clamp(0, adj.shape[0] - 1)]  # [B, M]
        nbrs = torch.where(slots[:, None] < 0, -1, nbrs)
        d = score_rows(space, qenc, corpus, nbrs)  # [B, M]
        best = torch.argmin(d, dim=1, keepdim=True)
        best_d = torch.gather(d, 1, best)[:, 0]
        best_i = torch.gather(nbrs, 1, best)[:, 0]
        improve = best_d < cur_d
        cur = torch.where(improve, best_i, cur)
        cur_d = torch.where(improve, best_d, cur_d)
        counters["descent_syncs"] += 1
        if not bool(improve.any()):
            break
    return cur, cur_d


def beam_search(
    space,
    qenc: dict,
    corpus: dict,
    adj: torch.Tensor,  # i32[S, M] (slot-indexed; level-0 slot == corpus idx)
    slot_of,  # i32[N] or None when slot==idx
    entry: torch.Tensor,  # i32[B] entry node per query
    ef: int,
    expand: int = 4,
    max_iters: int | None = None,
    nbr_store=None,  # ([S, M, D] replicated neighbour rows, dequant scale)
):
    """Batched best-first beam search on one graph level.

    Returns (beam_d f32[B,ef], beam_i i32[B,ef]) sorted ascending, plus
    the number of candidate scorings performed as a 0-d device tensor
    (dist-comp counter analog, reference: query.h:33).

    ``nbr_store``: optional DiskANN-style neighbourhood replication: each
    node's neighbours' vectors stored contiguously ([S, M, D], bf16 or
    int8). Expanding a parent then reads one contiguous M*D block instead
    of M separate rows. Scores pick up the store's rounding (fine for beam
    ordering); callers re-score the final top-k exactly (methods/hnsw.py
    _search_core). Only valid for spaces whose per-row term is
    recomputable from the row (or absent): the caller gates this.
    """
    b = entry.shape[0]
    m = adj.shape[1]
    k_cand = expand * m
    dev = entry.device
    if max_iters is None:
        max_iters = max(2 * ((ef + expand - 1) // expand) + 4, 8)
    # columns >= ef (there are some only when ef < expand) are masked INF, so
    # the semantics are exactly a beam of ef
    ef_w = max(ef, expand)

    entry_d = score_rows(space, qenc, corpus, entry[:, None])[:, 0]
    beam_d = torch.full((b, ef_w), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = entry_d
    beam_i = torch.full((b, ef_w), -1, dtype=adj.dtype, device=dev)
    beam_i[:, 0] = entry
    expanded = torch.zeros((b, ef_w), dtype=torch.bool, device=dev)
    lane_ok = (torch.arange(ef_w, device=dev) < ef)[None, :]
    no_flags = torch.zeros((b, k_cand), dtype=torch.bool, device=dev)
    first_col = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    ndist = torch.zeros((), dtype=torch.int64, device=dev)
    n_rows = corpus["vecs"].shape[0]

    for _ in range(max_iters):
        unexp_d = torch.where(expanded | (beam_i < 0), INF, beam_d)
        frontier_best = unexp_d.min(dim=1).values
        worst = torch.where(lane_ok, beam_d, -INF).max(dim=1).values
        # classic HNSW stop rule, plus "frontier exhausted" cutoff
        counters["beam_syncs"] += 1
        if not bool(((frontier_best <= worst) & (frontier_best < INF)).any()):
            break
        counters["beam_iters"] += 1

        # pick EXPAND closest unexpanded entries per query
        vals, pos = T.smallest_k(unexp_d, expand)  # [B, E] positions
        parent_valid = vals < INF
        parents = torch.where(parent_valid, torch.gather(beam_i, 1, pos), -1)
        expanded2 = expanded.scatter(1, pos, True)

        # gather adjacency rows of the parents
        if slot_of is not None:
            pslots = slot_of[parents.clamp(0, slot_of.shape[0] - 1)]
            pslots = torch.where(parents < 0, -1, pslots)
        else:
            pslots = parents
        nbrs = adj[pslots.clamp(0, adj.shape[0] - 1)]  # [B, E, M]
        nbrs = torch.where(pslots[:, :, None] < 0, -1, nbrs).reshape(b, k_cand)
        # the entry sits in the beam from iteration 0 (scored exactly at beam
        # setup, where the store's copy is dequantized): never a candidate
        cand = torch.where(nbrs == entry[:, None], -1, nbrs)

        if nbr_store is not None:
            # one [M, D] block per parent; rows are position-aligned with
            # nbrs == cand, masked entries score INF via pad
            store_rows, store_scale = nbr_store
            prows = store_rows[pslots.clamp(0, store_rows.shape[0] - 1)]
            crows = prows.reshape(b, k_cand, -1).float() * store_scale
            pad = _row_pad(corpus, cand, cand.clamp(0, n_rows - 1))
            d = score_gathered(space, qenc, crows, pad, inject_term(space, crows, {}))
            d = torch.where(cand < 0, INF, d)
        else:
            d = score_rows(space, qenc, corpus, cand)  # [B, K]
        scored = (cand >= 0).sum()

        # merge candidates into the beam: the beam's copy of a node comes
        # first and carries the expanded flag; stability keeps it ahead of
        # candidate copies through the id sort
        all_d = torch.cat([beam_d, d], dim=1)
        all_i = torch.cat([beam_i, cand], dim=1)
        all_e = torch.cat([expanded2, no_flags], dim=1)
        si, order = torch.sort(all_i, dim=1, stable=True)
        sd = torch.gather(all_d, 1, order)
        se = torch.gather(all_e, 1, order)
        run = torch.cat([first_col, (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)], dim=1)
        sd = torch.where(run, INF, sd)
        si = torch.where(run, -1, si)
        se = se & ~run
        sd, order = torch.sort(sd, dim=1, stable=True)
        sd, order = sd[:, :ef_w], order[:, :ef_w]
        si = torch.gather(si, 1, order)
        se = torch.gather(se, 1, order)
        # mask out slots beyond the logical beam width
        beam_d = torch.where(lane_ok, sd, INF)
        beam_i = torch.where(lane_ok, si, -1)
        expanded = se
        ndist = ndist + scored
    return beam_d[:, :ef], beam_i[:, :ef], ndist


# ---------------- neighbour-selection heuristic ----------------


def select_neighbors_heuristic(
    base_d: torch.Tensor,  # f32[B, C] candidate -> base distances (INF = invalid)
    cand_pair_d: torch.Tensor,  # f32[B, C, C] candidate pairwise distances
    m: int,
    exact: bool = True,
):
    """HNSW neighbour-selection heuristic (delaunay_type=2, reference:
    hnsw.h:129-168): scanning candidates in increasing base distance,
    keep c iff d(c, base) < d(c, s) for every already-kept s; stop at m.

    Vectorized over the batch; the candidate scan is a host loop of C
    steps over [B, C] masks. ``exact=False`` uses the one-shot RNG-rule
    relaxation (compare against all *closer* candidates instead of only
    kept ones): fully parallel, slightly stronger pruning.

    Returns keep mask bool[B, C] with at most m True per row.
    """
    b, c = base_d.shape
    sorted_d, order = torch.sort(base_d, dim=1, stable=True)  # positions sorted by base dist
    # reorder pairwise distances into sorted candidate order
    pair = torch.gather(cand_pair_d, 1, order[:, :, None].expand(b, c, c))
    pair = torch.gather(pair, 2, order[:, None, :].expand(b, c, c))
    # conflict[b, i, j]: candidate i lies closer to candidate j than to the base
    conflict = pair < sorted_d[:, :, None]
    valid = sorted_d < INF

    if not exact:
        closer = sorted_d[:, None, :] < sorted_d[:, :, None]  # j closer than i
        keep_sorted = ~(closer & conflict).any(dim=2) & valid
    else:
        # candidate i survives iff no kept j < i conflicts with it and fewer
        # than m are kept; columns >= i of ``keep`` are still False at step i
        keep_sorted = torch.zeros((b, c), dtype=torch.bool, device=base_d.device)
        kept = torch.zeros(b, dtype=torch.int32, device=base_d.device)
        # valid candidates sort first: past the longest row's count no step
        # keeps anything, and one sync here saves those steps (most of them
        # on the sparse upper levels)
        steps = int(valid.sum(dim=1).max()) if b else 0
        for i in range(steps):
            ok = ~(keep_sorted & conflict[:, i]).any(dim=1) & valid[:, i] & (kept < m)
            keep_sorted[:, i] = ok
            kept = kept + ok

    # cap at m (relevant for the rng mode; exact mode already capped)
    keep_sorted = keep_sorted & (torch.cumsum(keep_sorted, dim=1) <= m)
    # scatter back to original candidate positions
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def pack_selected(ids: torch.Tensor, keep: torch.Tensor, m: int) -> torch.Tensor:
    """Compress kept candidate ids [B, C] into fixed rows [B, m] (-1 pad),
    preserving ascending-distance order when ids are pre-sorted."""
    _, order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)
    packed = torch.gather(torch.where(keep, ids, -1), 1, order)
    return packed[:, :m]
