"""NN-descent k-NN-graph construction (counterpart of
tpu_knn/ops/nndescent.py): the alternative to batched insertion waves for
HNSW level 0, and the build ``Index("l2")`` takes from
``buildAlgoAutoN`` (300,000) rows up.

It replaces the *construction* algorithm only (reference:
src/method/hnsw.cc:183-338, sequential insertion); the index it produces
is the same layered graph, searched by the same batched beam
(ops/graph.py). NN-descent (Dong et al., WWW'11) refines every node's
k-NN list in whole-corpus sweeps:

  * state: each node's current k-NN list (adj [S, k], dist [S, k]);
  * per sweep: symmetrize (forward + capped reverse edges) -> B; replicate
    each node's neighbourhood rows contiguously (store = xq[B], int8), so
    a node's candidate set B[B[i]] is scored from kb row blocks; keep
    each parent's best t and merge them into the list with an (id, d) /
    (d, id) double sort that is safe for duplicates;
  * the final sweep re-scores every survivor exactly (f32 corpus rows)
    and appends random long links, so that the pruning ranks true
    neighbours and has far edges to keep.

Then heuristic pruning with reverse links, exact upper levels, one beam
polish through the built graph and a reachability repair.

Scoring uses the space's affine pass-1 factorization with both sides
derived from corpus rows (``space.rows_as_queries``): no second encoded
corpus copy. Eligible spaces: ``l2``, ``cosinesimil``, ``angulardist``,
``negdotprod`` and ``l2sqr_sift`` (int8 rows, exact).

Everything is plain torch ops on the corpus' device. What differs from
tpu_knn, with the same results:

  * each ``fori_loop`` over node chunks is a host loop; every chunk reads
    the frozen inputs and writes its rows of a preallocated output
    (Jacobi, as in tpu_knn). The descent reads its update count on the
    host once a sweep, as tpu_knn does;
  * ``lax.sort`` with two keys is a lexicographic stable sort: here a
    stable sort by the second key, then a stable sort by the first;
  * the polish is one host-chunked loop. tpu_knn's fused polish program
    (``_polish_sweep``, ``fuse``, ``POLISH_FUSE_MAX``) and the buffer
    donation of ``_polish_chunk_step`` work around a fault of the TPU
    worker and have no counterpart; the chunk size, which decides each
    batched beam's length, is tpu_knn's.

No float scatter-add anywhere and every sort is stable: two builds from
one seed are ``torch.equal`` on a GPU too. Products are IEEE f32 matmuls
(ops/distance.py); the descent's bf16 scoring rounds the operands to bf16
and takes an f32 product, as ``preferred_element_type=float32`` does
(see _score_from_rows for its row term).
"""

from __future__ import annotations

import numpy as np
import torch

from . import graph as G
from .distance import batched_dot, pair_dot
from .topk import INF, smallest_k

#: invalid-id sentinel that sorts after every real id (the dedup sorts)
IDBIG = 2**30
#: scoring rows this wide (bytes) are gathered per candidate, not through
#: the replicated neighbourhood store (see _descent_body)
WIDE_ROW_BYTES = 512


# ---------------- scoring from rows ----------------


def _dequant(rows, xscale: float):
    """Scoring rows as the descent reads them, in f32: bf16(rows) *
    bf16(xscale) (exact in f32: both factors have 8 significant bits)."""
    r = rows.to(torch.bfloat16).float()
    if xscale != 1.0:
        r = r * float(torch.tensor(xscale, dtype=torch.bfloat16))
    return r


def _score_from_rows(space, qenc: dict, rows, xscale: float, x_term=None):
    """Distances between per-chunk queries qenc['q'] [C, D] and candidate
    rows [C, ..., D] (broadcast over middle dims). rows may be a quantized
    store (int8 * xscale); the row term is that of the dequantized rows,
    ``x_term`` [C, ...] where the caller has it from a per-row table.

    Scoring is at bf16 (f32 accumulation): it ranks descent candidates
    only, the final sweep re-scores every survivor exactly, and the int8
    store (~1/127 relative) is coarser than bf16 rounding anyway. The
    product takes both sides rounded to bf16, the rows as
    bf16(bf16(rows) * bf16(xscale)), in an IEEE f32 matmul (never a bf16
    matmul, whose output torch rounds to bf16). The row term takes the
    dequantized rows before that last rounding (:func:`_dequant`):
    tpu_knn's compiled program keeps the bf16 product in f32 there (XLA's
    excess precision, on by default), and the port ranks candidates as
    that program does."""
    scale, sq, sx = space.pass1_affine()
    q = qenc["q"].to(torch.bfloat16).float()
    rb = rows.to(torch.bfloat16)
    if xscale != 1.0:
        rb = rb * torch.tensor(xscale, dtype=torch.bfloat16, device=rows.device)
    c, d = q.shape
    g = batched_dot(q, rb.float().reshape(c, -1, d)).reshape(rows.shape[:-1])
    del rb
    s = scale * g
    if sq != 0.0 and "q_term" in qenc:
        qt = qenc["q_term"]
        s = s + sq * qt.reshape(qt.shape + (1,) * (g.ndim - 1))
    if sx != 0.0:
        t = x_term if x_term is not None else space.term_from_rows(_dequant(rows, xscale))
        if t is not None:
            s = s + sx * t
    return space.pass1_post(s, qenc)


def pairs_from_rows(space, rows):
    """All-pairs distances within each row set: rows [C, K, D] ->
    [C, K, K], using rows as their own query encodings: one batched f32
    product."""
    qe = space.rows_as_queries(rows)
    scale, sq, sx = space.pass1_affine()
    b = rows.float()
    g = pair_dot(qe["q"].float(), b)
    s = scale * g
    if sq != 0.0 and "q_term" in qe:
        s = s + sq * qe["q_term"][:, :, None]
    if sx != 0.0:
        t = space.term_from_rows(b)
        if t is not None:
            s = s + sx * t[:, None, :]
    return space.pass1_post(s, qe)


# ---------------- sort and group pieces ----------------


def _sort2(k1, k2, *payload):
    """Lexicographic stable sort of each row by (k1, k2) (``lax.sort`` with
    num_keys=2): a stable sort by k2, then a stable sort by k1. Returns
    (k1, k2, *payload) in that order."""
    k2, o = torch.sort(k2, dim=-1, stable=True)
    k1 = torch.gather(k1, -1, o)
    payload = [torch.gather(p, -1, o) for p in payload]
    k1, o = torch.sort(k1, dim=-1, stable=True)
    return (k1, torch.gather(k2, -1, o), *(torch.gather(p, -1, o) for p in payload))


def _group_prefix(sn, sp, s_rows: int, width: int, *extra):
    """Scatter-free grouped gather: pairs sorted by target ``sn`` (IDBIG for
    invalid ones) with payload ``sp``; target t's first ``width`` pairs sit
    at [gstart[t], gstart[t] + width). Returns (payload [S, width] with -1
    where t has fewer, hit mask, *extra gathered likewise)."""
    npairs = sn.shape[0]
    rows = torch.arange(s_rows, dtype=sn.dtype, device=sn.device)
    gstart = torch.searchsorted(sn, rows)
    idx = gstart[:, None] + torch.arange(width, device=sn.device)[None, :]
    inb = idx < npairs
    idx = torch.where(inb, idx, npairs - 1)
    hit = inb & (sn[idx] == rows[:, None])
    return (torch.where(hit, sp[idx], -1), hit, *(e[idx] for e in extra))


def _make_b(adj, krev: int, count: int):
    """Symmetrized neighbourhood B = [forward | capped reverse] i32[S, kb].

    Every forward pair (src -> tgt) competes for one of tgt's krev reverse
    slots, first come by src order (a stable argsort by target), gathered
    by binary search: no scatter. Pad-state rows (src >= count) emit no
    pairs."""
    s_rows, k = adj.shape
    src = torch.arange(s_rows, dtype=torch.int32, device=adj.device)[:, None].expand(s_rows, k).reshape(-1)
    tgt = adj.reshape(-1)
    valid = (tgt >= 0) & (src < count)
    skey = torch.where(valid, tgt, IDBIG)
    sn, order = torch.sort(skey, stable=True)
    rev, _ = _group_prefix(sn, src[order], s_rows, krev)
    return torch.cat([adj, rev.to(adj.dtype)], dim=1)


def _gather_store(xq, b):
    """Neighbourhood row replication: store[i] = xq[B[i]] ([S, kb, D])."""
    return xq[b.clamp(0, xq.shape[0] - 1)]


def _merge_dedup_sorted(all_d, all_i, k: int):
    """(id, d)-sort -> run-dedup (keep the least d per id) -> (d, id)-sort
    -> first k. Safe where one id carries bitwise-different scores
    (store-quantized against exact)."""
    ids = torch.where(all_d >= INF, IDBIG, all_i)
    ids = torch.where(ids < 0, IDBIG, ids)
    d = torch.where(ids == IDBIG, INF, all_d)
    ids, d = _sort2(ids, d)
    run = torch.cat(
        [torch.zeros_like(ids[:, :1], dtype=torch.bool), (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] < IDBIG)],
        dim=1,
    )
    d = torch.where(run, INF, d)
    ids = torch.where(run, IDBIG, ids)
    d, ids = _sort2(d, ids)
    d, ids = d[:, :k], ids[:, :k]
    return d, torch.where(ids == IDBIG, -1, ids).to(all_i.dtype)


def _chunk_starts(n_state: int, chunk: int):
    """(base, start) of each chunk: ``start`` clamped to n_state - chunk as
    ``lax.dynamic_slice`` clamps it; ``base`` is the unclamped offset
    tpu_knn numbers the chunk's nodes from."""
    nc = (n_state + chunk - 1) // chunk
    return [(ci * chunk, min(ci * chunk, n_state - chunk)) for ci in range(nc)]


# ---------------- sweeps ----------------


def _descent_body(space, adj, dist, b, store, xq, xterm, qvecs, base: int, *, t_keep: int, count: int,
                  chunk: int, xscale: float):
    """One refinement step for nodes [base, base+chunk): score the
    candidate set B[B[i]] from neighbourhood rows, keep each parent's best
    t_keep, merge into the current k-NN list. Returns (dist_c, adj_c,
    changed count as a 0-d tensor) for the chunk.

    ``store is None`` = wide-row mode: candidate rows are gathered
    straight from ``xq`` per (node, parent, slot). The replicated store
    turns kb^2 small row gathers into kb contiguous blocks; at a row width
    of 512 bytes or more each row is already such a block, and the
    resident store (n*kb*D bytes) is not worth its memory.

    ``xterm`` [N]: the row term of each scoring row, gathered per
    candidate instead of reduced over D per candidate (None: no term)."""
    k = adj.shape[1]
    kb = b.shape[1]
    dev = adj.device
    adj_c = adj[base:base + chunk]
    dist_c = dist[base:base + chunk]
    node = base + torch.arange(chunk, dtype=torch.int32, device=dev)
    # query side from the exact corpus rows (only candidate rows ride the
    # quantized store): half the quantization noise for free
    qe = space.rows_as_queries(qvecs[node.clamp(0, qvecs.shape[0] - 1)])

    b_c = b[base:base + chunk]  # [C, kb]
    safe_p = b_c.clamp(0, b.shape[0] - 1)
    cand = b[safe_p]  # [C, kb, kb]
    cand = torch.where(b_c[:, :, None] < 0, -1, cand)
    if store is None:
        rows = xq[cand.clamp(0, xq.shape[0] - 1)]  # [C, kb, kb, D]
    else:
        rows = store[safe_p]  # [C, kb, kb, D]
    x_term = None if xterm is None else xterm[cand.clamp(0, xterm.shape[0] - 1)]
    d3 = _score_from_rows(space, qe, rows, xscale, x_term)  # [C, kb, kb]
    del rows, x_term
    bad = (cand < 0) | (cand >= count) | (cand == node[:, None, None])
    d3 = torch.where(bad, INF, d3)

    if t_keep < kb:
        d3, o = torch.sort(d3, dim=2, stable=True)
        d3, cand = d3[:, :, :t_keep], torch.gather(cand, 2, o[:, :, :t_keep])
    all_d = torch.cat([dist_c, d3.reshape(chunk, -1)], dim=1)
    all_i = torch.cat([adj_c, cand.reshape(chunk, -1)], dim=1)
    nd, ni = _merge_dedup_sorted(all_d, all_i, k)
    return nd, ni, (ni != adj_c).sum()


def _descent_sweep(space, adj, dist, b, store, xq, xterm, qvecs, *, t_keep: int, count: int, chunk: int,
                   xscale: float):
    """One full refinement sweep: every chunk reads the same frozen
    adj/dist/b/store and writes its rows of fresh outputs (Jacobi).
    Returns (adj, dist, changed as a 0-d device tensor)."""
    adj_new, dist_new = torch.empty_like(adj), torch.empty_like(dist)
    changed = torch.zeros((), dtype=torch.int64, device=adj.device)
    for base in range(0, adj.shape[0], chunk):
        nd, ni, ch = _descent_body(space, adj, dist, b, store, xq, xterm, qvecs, base, t_keep=t_keep, count=count,
                                   chunk=chunk, xscale=xscale)
        adj_new[base:base + chunk], dist_new[base:base + chunk] = ni, nd
        changed += ch
    return adj_new, dist_new, changed


def _exact_rows(space, corpus, cand, base: int, count: int):
    """Exact distances of nodes [base, base + C) to their candidates
    ``cand`` [C, W] from the f32 corpus rows; self and pad-state
    candidates score INF."""
    node = base + torch.arange(cand.shape[0], dtype=torch.int32, device=cand.device)
    vecs = corpus["vecs"]
    qe = space.rows_as_queries(vecs[node.clamp(0, vecs.shape[0] - 1)])
    d = G.score_rows(space, qe, corpus, cand)
    return torch.where((cand == node[:, None]) | (cand >= count), INF, d)


def _exact_sweep(space, corpus, adj, *, count: int, chunk: int):
    """Exact re-score of every chunk's lists (authoritative dedup and
    order). Returns (dist, adj)."""
    dist_new = torch.full(adj.shape, INF, device=adj.device)
    adj_new = torch.full_like(adj, -1)
    for base in range(0, adj.shape[0], chunk):
        adj_c = adj[base:base + chunk]
        d = _exact_rows(space, corpus, adj_c, base, count)
        dist_new[base:base + chunk], adj_new[base:base + chunk] = _merge_dedup_sorted(d, adj_c, adj.shape[1])
    return dist_new, adj_new


def _exact_aug_sweep(space, corpus, adj, rand, *, count: int, chunk: int):
    """Exact re-score of [k-NN list | random long-link candidates].

    A k-NN list holds no long edges, so the selection heuristic could keep
    none, and greedy routing on the result strands in local pockets. A
    far random node is rarely dominated by near neighbours, so the
    diversity rule keeps it (Kleinberg's small world). Returns (dist,
    adj) of width k + r, ascending by exact distance."""
    w = adj.shape[1] + rand.shape[1]
    dist_new = torch.full((adj.shape[0], w), INF, device=adj.device)
    adj_new = torch.full((adj.shape[0], w), -1, dtype=adj.dtype, device=adj.device)
    for base in range(0, adj.shape[0], chunk):
        cand = torch.cat([adj[base:base + chunk], rand[base:base + chunk]], dim=1)
        d = _exact_rows(space, corpus, cand, base, count)
        dist_new[base:base + chunk], adj_new[base:base + chunk] = _merge_dedup_sorted(d, cand, w)
    return dist_new, adj_new


def _heur_select(space, corpus, adj_c, dist_c, m: int, exact_rule: bool, fill: bool):
    """Neighbour-selection heuristic over (ascending, deduped) candidate
    lists; pair distances from one batched product over the gathered rows
    (pairs_from_rows). Returns (sel i32[B, m], seld f32[B, m]).

    ``fill``: top the survivors up to m with the nearest pruned
    candidates (hnswlib's keepPrunedConnections). A k-NN candidate list is
    all near, so the domination rule alone keeps about half the edges of
    the wave build and hurts navigability."""
    vecs = corpus["vecs"]
    rows = vecs[adj_c.clamp(0, vecs.shape[0] - 1)]
    pair_d = pairs_from_rows(space, rows)
    pair_d = torch.where((adj_c[:, :, None] < 0) | (adj_c[:, None, :] < 0), INF, pair_d)
    base_d = torch.where(adj_c < 0, INF, dist_c)
    keep = G.select_neighbors_heuristic(base_d, pair_d, m, exact=exact_rule)
    # kept first (ascending d), then pruned but valid (ascending d); keys
    # are distinct within a row
    c = adj_c.shape[1]
    pos = torch.arange(c, device=adj_c.device).expand(adj_c.shape)
    key = torch.where(keep, pos, c + pos)
    key = torch.where((adj_c >= 0) & (base_d < INF), key, 2 * c + pos)
    selkey, order = torch.sort(key, dim=1)
    sel = torch.gather(adj_c, 1, order)[:, :m]
    seld = torch.gather(base_d, 1, order)[:, :m]
    ok = selkey[:, :m] < (2 * c if fill else c)
    return torch.where(ok, sel, -1), torch.where(ok, seld, INF)


def _prune_sweep(space, corpus, adj, dist, *, m: int, chunk: int, exact_rule: bool, fill: bool, heur: bool):
    """Forward selection for every node: the heuristic over its k-NN list
    (or the m closest for delaunay_type=0). Returns (sel i32[S, m], seld
    f32[S, m])."""
    s_rows = adj.shape[0]
    sel = torch.full((s_rows, m), -1, dtype=adj.dtype, device=adj.device)
    seld = torch.full((s_rows, m), INF, device=adj.device)
    for _, start in _chunk_starts(s_rows, chunk):
        adj_c, dist_c = adj[start:start + chunk], dist[start:start + chunk]
        if heur:
            s, sd = _heur_select(space, corpus, adj_c, dist_c, m, exact_rule, fill)
        else:
            s, sd = adj_c[:, :m], dist_c[:, :m]
        # fewer than m candidates (a small upper level): the first columns
        sel[start:start + chunk, :s.shape[1]], seld[start:start + chunk, :s.shape[1]] = s, sd
    return sel, seld


def _rev_nearest(sel, seld, krev: int, count: int):
    """Nearest ``krev`` reverse sources per target: every forward edge
    (src -> tgt, d) competes for tgt's reverse slots by distance (stable
    sort by (tgt, d) -> first krev per group), unlike _make_b's first-come
    race. Returns (rev i32[S, krev], revd f32[S, krev])."""
    s_rows, m = sel.shape
    src = torch.arange(s_rows, dtype=torch.int32, device=sel.device)[:, None].expand(s_rows, m).reshape(-1)
    tgt = sel.reshape(-1)
    d = seld.reshape(-1)
    valid = (tgt >= 0) & (src < count) & (d < INF)
    skey = torch.where(valid, tgt, IDBIG)
    dkey = torch.where(valid, d, INF)
    sn, sd, sp = _sort2(skey, dkey, src)
    rev, hit, dd = _group_prefix(sn, sp, s_rows, krev, sd)
    return rev.to(sel.dtype), torch.where(hit, dd, INF)


def _shrink_sweep(space, corpus, sel, seld, rev, revd, *, cap: int, chunk: int, exact_rule: bool, fill: bool,
                  heur: bool):
    """Final adjacency: per node, heuristic shrink over [forward-selected |
    nearest reverse sources] with their exact distances, the batched
    counterpart of hnswlib's bidirectional-link overflow shrink
    (reference hnsw.h:258-314). A reverse edge competes by distance and
    diversity, so a node that selects its true neighbours earns in-edges
    from them."""
    s_rows = sel.shape[0]
    out = torch.full((s_rows, cap), -1, dtype=sel.dtype, device=sel.device)
    for base, start in _chunk_starts(s_rows, chunk):
        node = base + torch.arange(chunk, dtype=torch.int32, device=sel.device)
        cand = torch.cat([sel[start:start + chunk], rev[start:start + chunk]], dim=1)
        d = torch.cat([seld[start:start + chunk], revd[start:start + chunk]], dim=1)
        d = torch.where((cand < 0) | (cand == node[:, None]), INF, d)
        d, cand = _merge_dedup_sorted(d, cand, cand.shape[1])
        if heur:
            rows, _ = _heur_select(space, corpus, cand, d, cap, exact_rule, fill)
        else:
            rows = cand[:, :cap]
        out[start:start + chunk] = rows
    return out


def _reverse_fill(sel, cap: int, count: int):
    """Final adjacency: forward-selected edges + reverse edges packed to
    ``cap`` per row (m forward + cap - m reverse slots, so nothing
    overflows and nothing is scored)."""
    s_rows, m = sel.shape
    krev = max(cap - m, 0)
    if krev == 0:
        return sel[:, :cap]
    rev = _make_b(sel, krev, count)[:, m:]  # [S, krev]
    dup = (rev[:, :, None] == sel[:, None, :]).any(dim=2)
    own = rev == torch.arange(s_rows, dtype=rev.dtype, device=rev.device)[:, None]
    rev = torch.where(dup | own, -1, rev)
    allx = torch.cat([sel, rev], dim=1)
    return G.pack_selected(allx, allx >= 0, cap)


# ---------------- entry points ----------------


def _quantize(vecs):
    """(int8 rows, scale): symmetric per-tensor int8 of an f32 corpus (the
    int8 neighbour store's recipe); int8 corpora pass through."""
    if vecs.dtype == torch.int8:
        return vecs, 1.0
    s = float(vecs.abs().max()) / 127.0
    xscale = s if s > 0 else 1.0
    return torch.clamp(torch.round(vecs / xscale), -127, 127).to(torch.int8), xscale


def build_knn_graph(space, corpus: dict, n: int, *, k: int, iters: int, krev: int, t_keep: int, chunk: int,
                    seed: int, store_dtype: str = "int8", min_update_frac: float = 1e-3, n_random: int = 6,
                    progress=None, mark=None):
    """Exact-rescored approximate k-NN graph. Returns (dist f32[S, k], adj
    i32[S, k]) on the corpus' device, rows ascending by exact distance; S
    is n rounded up to the chunk size (rows >= n are all -1/INF)."""
    vecs = corpus["vecs"]
    dev = vecs.device
    n_pad = vecs.shape[0]
    c_eff = int(min(chunk, max(128, n_pad)))
    nc = (n_pad + c_eff - 1) // c_eff
    n_state = nc * c_eff

    # the scoring copy: int8 corpora (l2sqr_sift, exact) pass through; f32
    # corpora quantize to int8 unless nndStoreDtype is float32
    if vecs.dtype == torch.int8 or store_dtype == "float32":
        xq, xscale = vecs, 1.0
    else:
        xq, xscale = _quantize(vecs)

    # random init (seeded, self-free); pad-state rows stay empty
    rng = np.random.default_rng(seed)
    init = rng.integers(0, max(n, 1), size=(n_state, k), dtype=np.int64)
    init = np.where(init == (np.arange(n_state)[:, None]), (init + 1) % max(n, 1), init)
    init[n:] = -1
    adj = torch.from_numpy(init.astype(np.int32)).to(dev)
    dist, adj = _exact_sweep(space, corpus, adj, count=n, chunk=c_eff)
    if mark:
        mark("init_exact")

    wide_rows = vecs.shape[1] * xq.element_size() >= WIDE_ROW_BYTES
    _, _, sx = space.pass1_affine()
    xterm = space.term_from_rows(_dequant(xq, xscale)) if sx != 0.0 else None

    store = None
    for it in range(iters):
        # free the previous sweep's store before gathering the next, or two
        # stores sit resident (16+ GB at 1M x kb=64 x 128)
        store = None
        b = _make_b(adj, krev, n)
        if not wide_rows:
            store = _gather_store(xq, b)
        adj, dist, ch = _descent_sweep(space, adj, dist, b, store, xq, xterm, vecs, t_keep=t_keep, count=n,
                                       chunk=c_eff, xscale=xscale)
        changed = int(ch)  # the one host sync of a sweep
        if progress:
            progress(it, changed)
        if changed <= min_update_frac * n * k:
            break
    if mark:
        mark("descent_sweeps")

    # the neighbourhood store (8.2 GB at 1M) is descent-only state: free it
    # before the final exact pass
    b = store = xterm = None
    r = max(n_random, 1)
    rnd = rng.integers(0, max(n, 1), size=(n_state, r)).astype(np.int32)
    rnd[n:] = -1
    rand = torch.from_numpy(rnd).to(dev)
    dist, adj = _exact_aug_sweep(space, corpus, adj, rand, count=n, chunk=c_eff)
    if mark:
        mark("final_exact")
    return dist, adj


def prune_and_link(space, corpus: dict, dist, adj, n: int, *, m: int, cap: int, chunk: int, selection: str = "heur",
                   fill: bool = True, rev_mode: str = "shrink", mark=None):
    """k-NN lists -> navigable adjacency: heuristic forward selection to m
    edges (pruned-fill per ``fill``), then reverse linking to ``cap``.
    Returns i32[S, cap].

    rev_mode="shrink" (default): gather each node's nearest ``cap``
    reverse sources and heuristic-shrink [forward | reverse] with exact
    distances (bidirectional insertion, hnsw.h:258-314).
    rev_mode="slots": the first-come reverse slot fill."""
    n_state = adj.shape[0]
    c_eff = int(min(chunk, n_state))
    heur = selection != "none"
    exact_rule = selection != "rng"
    sel, seld = _prune_sweep(space, corpus, adj, dist, m=m, chunk=c_eff, exact_rule=exact_rule, fill=fill,
                             heur=heur)
    if mark:
        mark("pl_prune")
    if rev_mode == "slots":
        return _reverse_fill(sel, cap, n)
    rev, revd = _rev_nearest(sel, seld, cap, n)
    if mark:
        mark("pl_rev")
    out = _shrink_sweep(space, corpus, sel, seld, rev, revd, cap=cap, chunk=c_eff, exact_rule=exact_rule,
                        fill=fill, heur=heur)
    if mark:
        mark("pl_shrink")
    return out


# ---------------- beam polish ----------------


def _polish_chunk_math(space, corpus, level0, uppers, dist, adj, store, base: int, *, efc: int, expand: int,
                       entry: int, count: int, chunk: int):
    """One polish chunk: the query path (greedy upper descent + level-0
    beam at efConstruction) for ``chunk`` nodes at ``base``, merged
    untruncated into their k-NN lists.

    Why: the NN-descent candidate pool is all near (k-NN) plus all far
    (uniform randoms), so the pruned graph lacks the distance-halving
    edges greedy routing needs at every scale. The wave build never
    lacks them: every node's candidates come from an efConstruction beam,
    path candidates at every distance. This pass gives every node that
    candidate distribution at once (Jacobi re-insertion)."""
    dev = adj.device
    node = base + torch.arange(chunk, dtype=torch.int32, device=dev)
    vecs = corpus["vecs"]
    qe = space.rows_as_queries(vecs[node.clamp(0, vecs.shape[0] - 1)])
    cur = torch.full((chunk,), entry, dtype=torch.int32, device=dev)
    cur_d = G.score_rows(space, qe, corpus, cur[:, None])[:, 0]
    for adj_u in reversed(uppers):
        cur, cur_d = G.greedy_descent(space, qe, corpus, adj_u, None, cur, cur_d)
    bd, bi, _ = G.beam_search(space, qe, corpus, level0, None, cur, ef=efc, expand=expand, nbr_store=store)
    if store is not None:
        # the beam explored on int8 rows (ranking only); the merged
        # distances feed the selection heuristic, so re-score exactly
        bd = G.score_rows(space, qe, corpus, bi)
    bd = torch.where((bi == node[:, None]) | (bi >= count) | (bi < 0) | (node[:, None] >= count), INF, bd)
    cat_d = torch.cat([dist[base:base + chunk], bd], dim=1)
    cat_i = torch.cat([adj[base:base + chunk], bi.to(adj.dtype)], dim=1)
    # dedup without truncation: a nearest-width cut would let the beam's
    # near candidates displace the list's far and random entries, the
    # diversity the selection heuristic needs
    return _merge_dedup_sorted(cat_d, cat_i, cat_d.shape[1])


def polish_knn_lists(space, corpus, level0, uppers, dist, adj, n, *, efc: int, expand: int, entry: int, chunk: int,
                     use_store: bool = False, progress=None):
    """One beam-polish pass over all nodes (see _polish_chunk_math), one
    chunk at a time. Returns the augmented and re-merged (dist, adj),
    width + efc wide.

    ``use_store``: explore the polish beam on an int8 replicated-neighbour
    store gathered from the frozen level0 (one [cap, D] block per parent
    expansion instead of cap row gathers), with the survivors re-scored
    exactly before the merge. The caller gates eligibility (dense rows;
    methods/hnsw._cstore_ok). ``progress(ci, nc, state)``: optional host
    callback per chunk."""
    n_state = adj.shape[0]
    c_eff = int(min(chunk, n_state))
    nc = (n_state + c_eff - 1) // c_eff
    store = None
    if use_store:
        xq, xscale = _quantize(corpus["vecs"])
        store = (xq[level0.clamp(0, xq.shape[0] - 1)], xscale)  # [S, cap, D]
    # the state is padded to a chunk multiple, so every chunk is whole
    n2 = nc * c_eff
    if n2 != n_state:
        dist = torch.cat([dist, dist.new_full((n2 - n_state, dist.shape[1]), INF)])
        adj = torch.cat([adj, adj.new_full((n2 - n_state, adj.shape[1]), -1)])
    w_out = dist.shape[1] + efc  # beam_search returns [B, ef]
    dist_new = torch.full((n2, w_out), INF, device=dist.device)
    adj_new = torch.full((n2, w_out), -1, dtype=adj.dtype, device=adj.device)
    for ci in range(nc):
        base = ci * c_eff
        dist_new[base:base + c_eff], adj_new[base:base + c_eff] = _polish_chunk_math(
            space, corpus, level0, uppers, dist, adj, store, base, efc=efc, expand=expand, entry=int(entry),
            count=n, chunk=c_eff,
        )
        if progress is not None:
            progress(ci, nc, dist_new)
    return dist_new[:n_state], adj_new[:n_state]


# ---------------- reachability repair ----------------


def _reach_from_host(adj_np: np.ndarray, entry: int) -> np.ndarray:
    """Directed-reachability mask from ``entry``: frontier BFS on the host
    (each edge touched once). repair_reachability downloads the adjacency
    for its link writes anyway."""
    reach = np.zeros(adj_np.shape[0], bool)
    entry = int(entry)
    if not (0 <= entry < adj_np.shape[0]):
        return reach
    reach[entry] = True
    frontier = np.array([entry], np.int64)
    while frontier.size:
        tgt = adj_np[frontier].reshape(-1)
        tgt = tgt[(tgt >= 0) & (tgt < adj_np.shape[0])]
        tgt = np.unique(tgt)
        new = tgt[~reach[tgt]]
        reach[new] = True
        frontier = new
    return reach


def _nearest_reached_chunk(space, corpus, reached_pad, u_ids, best_d, best_i, base: int, *, count: int, csize: int):
    """One corpus chunk of the nearest-reached-node scan for the unreached
    batch u_ids; unreached rows carry +INF in ``reached_pad``."""
    vecs = corpus["vecs"]
    qe = space.rows_as_queries(vecs[u_ids.clamp(0, vecs.shape[0] - 1)])
    x = vecs[base:base + csize]
    xc = {"x": x, "pad": reached_pad[base:base + csize]}
    t = space.term_from_rows(x.float())
    if t is not None:
        xc["x_term"] = t
    d = space.block(qe, xc)  # [U, csize]
    cols = base + torch.arange(csize, dtype=torch.int32, device=d.device)[None, :]
    d = torch.where((cols == u_ids[:, None]) | (cols >= count), INF, d)
    dmin, am = d.amin(dim=1), torch.argmin(d, dim=1)  # argmin: the first of equal minima
    better = dmin < best_d
    return torch.where(better, dmin, best_d), torch.where(better, base + am.to(torch.int32), best_i)


def repair_reachability(space, corpus, adj, n, *, entry: int = 0, chunk: int = 65536, max_rounds: int = 8):
    """Make every real node reachable from ``entry`` along directed
    level-0 edges: the invariant insertion provides for free and a
    refinement-built k-NN graph does not (clustered data fragments into
    per-cluster components, and an unreachable node is invisible to every
    query at any ef). Each unreached node is linked from its exact nearest
    reached node (overwriting that node's last slot) and back, then
    reachability is propagated again. Returns the repaired adjacency and
    the number of repaired nodes."""
    s_rows, cap = adj.shape
    vecs = corpus["vecs"]
    dev = vecs.device
    repaired = 0
    for _ in range(max_rounds):
        host = adj.cpu().numpy().copy()  # one writable download per round (BFS + links)
        reach = _reach_from_host(host, entry)
        un = np.where(~reach[:n])[0]
        if un.size == 0:
            break
        upad = int(np.ceil(un.size / 128)) * 128
        u_ids = torch.from_numpy(np.concatenate([un, np.full(upad - un.size, n - 1)]).astype(np.int32)).to(dev)
        rp = np.full(vecs.shape[0], np.float32(INF))
        rp[:n][reach[:n]] = 0.0
        reached_pad = torch.from_numpy(rp).to(dev)
        best_d = torch.full((upad,), INF, device=dev)
        best_i = torch.full((upad,), -1, dtype=torch.int32, device=dev)
        csize = int(min(chunk, vecs.shape[0]))
        for ci in range((vecs.shape[0] + csize - 1) // csize):
            base = min(ci * csize, vecs.shape[0] - csize)
            best_d, best_i = _nearest_reached_chunk(space, corpus, reached_pad, u_ids, best_d, best_i, base,
                                                    count=n, csize=csize)
        tgt = best_i.cpu().numpy()[: un.size]
        ok = tgt >= 0
        un, tgt = un[ok], tgt[ok]
        if un.size == 0:
            break
        # one link per reached anchor this round (collisions retry next
        # round against the freshly reached set)
        _, first = np.unique(tgt, return_index=True)
        un, tgt = un[np.sort(first)], tgt[np.sort(first)]
        for u, t in zip(un, tgt):
            arow = host[t]  # anchor -> node: makes it reachable
            free = np.where(arow < 0)[0]
            arow[free[0] if free.size else cap - 1] = u
            row = host[u]  # node -> anchor: a way back out
            if t not in row:
                free = np.where(row < 0)[0]
                row[free[0] if free.size else cap - 1] = t
        adj = torch.from_numpy(host).to(dev)
        repaired += int(un.size)
    return adj, repaired


# ---------------- upper levels ----------------


def _level_knn_chunk(space, corpus, rand, base: int, *, n_l: int, k: int, chunk: int):
    """Exact k-NN of member chunk [base, base+chunk) among members [0, n_l)
    (level-sorted order makes every level a prefix), plus the node's
    random long-link candidates: one full-width block + top-k, since
    upper levels are small (N_l <= N/M)."""
    vecs = corpus["vecs"]
    dev = vecs.device
    node = base + torch.arange(chunk, dtype=torch.int32, device=dev)
    qe = space.rows_as_queries(vecs[node.clamp(0, vecs.shape[0] - 1)])
    n_lp = min(((n_l + 127) // 128) * 128, vecs.shape[0])
    x = vecs[:n_lp]
    xc = {"x": x, "pad": torch.where(torch.arange(n_lp, device=dev) >= n_l, INF, 0.0).to(torch.float32)}
    t = space.term_from_rows(x.float())
    if t is not None:
        xc["x_term"] = t
    d = space.block(qe, xc)  # [C, n_lp]
    cols = torch.arange(n_lp, dtype=torch.int32, device=dev)[None, :]
    d = torch.where(cols == node[:, None], INF, d)
    kk = min(k, n_lp)
    dk, ik = smallest_k(d, kk)
    rand_c = rand[base:base + chunk]
    rd = torch.gather(d, 1, rand_c.clamp(0, n_lp - 1).long())
    rd = torch.where((rand_c < 0) | (rand_c >= n_l), INF, rd)
    dk = torch.cat([dk, rd], dim=1)
    ik = torch.cat([ik.to(torch.int32), rand_c], dim=1)
    if kk < k:
        dk = torch.cat([dk, dk.new_full((chunk, k - kk), INF)], dim=1)
        ik = torch.cat([ik, ik.new_full((chunk, k - kk), -1)], dim=1)
    return _merge_dedup_sorted(dk, torch.where(dk >= INF, -1, ik), dk.shape[1])


def build_level_exact(space, corpus: dict, n_l: int, *, m: int, cap: int, k_cand: int, chunk: int,
                      selection: str = "heur", fill: bool = True, n_random: int = 6, seed: int = 0,
                      rev_mode: str = "shrink"):
    """One upper level: exact k-NN among the first n_l nodes + the same
    prune and reverse linking as level 0. Returns i32[n_l, cap]."""
    c_eff = int(min(chunk, max(n_l, 1)))
    nc = (n_l + c_eff - 1) // c_eff
    rng = np.random.default_rng(seed + 7919 * n_l)
    rnd = rng.integers(0, max(n_l, 1), size=(nc * c_eff, max(n_random, 1))).astype(np.int32)
    rand = torch.from_numpy(rnd).to(corpus["vecs"].device)
    parts = [_level_knn_chunk(space, corpus, rand, ci * c_eff, n_l=n_l, k=k_cand, chunk=c_eff) for ci in range(nc)]
    dist = torch.cat([p[0] for p in parts])
    adj = torch.cat([p[1] for p in parts])
    out = prune_and_link(space, corpus, dist, adj, n_l, m=m, cap=cap, chunk=c_eff, selection=selection, fill=fill,
                         rev_mode=rev_mode)
    return out[:n_l]
