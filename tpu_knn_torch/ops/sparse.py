"""Blocked sparse distance primitives over padded CSR (counterpart of
tpu_knn/ops/sparse.py).

The corpus is padded CSR: ``cols`` i32[N, nnz] ascending per row with
1-based element ids, ``vals`` f32[N, nnz] (0 at padding). Query rows pad
their ids with PAD_Q, corpus rows with PAD_X; the two sentinels differ and
lie above every real id, so a padded slot never matches anything. Every
distance factors through one of two lookups:

  dot(q, x)      = sum_t  qval_at(x.col[t]) * x.val[t]
  |A n B|        = sum_t  found(x.col[t])
  sum_U |q-x|^p  = sum_t (|x.val[t] - qat|^p - |qat|^p) + sum_s |q.val[s]|^p

(U the union of the supports, qat the query's value at x.col[t]).

One formulation per primitive, the one that suits the card; tpu_knn
ships others for reasons of its own (the TPU arm each matches is named):

  * dot products and intersection counts of a query batch against corpus
    rows: the scan's distances come from :func:`qdense_dists`, whose query
    side is the batch's term-major postings (:class:`Postings`, built by
    :func:`postings` with one stable sort). On the card it is one launch
    of the hand-written kernel ``csrc/sparse_qdense.cu``, which walks each
    corpus element's run of query records, so that its work follows the
    non-zero products, and applies the space's post (:func:`dot_post`).
    Its plain version, :func:`qdense_dists_reference`, densifies the
    postings into the query table f32[V, Q] (:func:`postings_table`, the
    table of :func:`densify_t`), looks each corpus element up in it and
    contracts over nnz with one batched product (:func:`dot_qdense`,
    :func:`intersect_count_qdense`), then posts. tpu_knn's scan does the
    same with a [Q, V] table (dot_qdense, SPARSE_SCAN_QDENSE).
  * gathered candidates [B, K, nnz] (the graph's beam) look their elements
    up in each query's own row of a [B, V] table (:func:`gathered_dot`,
    :func:`gathered_found`). tpu_knn ships GATHER_SCORING="support", an
    equality match against the query's support, because a gather inside a
    TPU while_loop compiled to a 2.6 s fusion; the products and matches
    are the same, and a gather is cheap here where torch would have to
    materialize the support form's [B, K, nnz, T] mask.
  * pairs of candidate rows (the construction heuristic) find each
    a-side element in the sorted b-side row by binary search
    (:func:`pair_lookup`) and add the products over the a-side
    (:func:`row_dot`): no [*, V] table per candidate. tpu_knn ships
    PAIR_BACKEND="support", an equality match in a fori_loop over the
    a-side slots; on the CPU the port adds in that loop's order, one fused
    multiply-add a slot, and equals it bit for bit.
  * the union-of-supports Lp distances binary-search the corpus elements
    in the sorted query rows (:func:`lookup_query_vals`, tpu_knn's
    searchsorted lookup; the Lp spaces have no vocabulary gate there
    either), and Linf also the query's elements in the corpus rows
    (:func:`reverse_found`).
  * the JL sketch densifies chunks of rows over the padded vocabulary and
    multiplies them with R (:func:`sketch_csr`, SKETCH_BACKEND="densify").

Every product runs at IEEE f32 (ops/distance.require_ieee_f32).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from ..utils.rng import jax_normal
from . import groupmin as GM
from .distance import block_elems, require_ieee_f32

#: Column padding sentinels (see module docstring)
PAD_Q = 2**31 - 1
PAD_X = 2**31 - 2


def densify(col: torch.Tensor, val: torch.Tensor, v_pad: int) -> torch.Tensor:
    """Scatter padded-CSR rows into a dense f32[rows, v_pad] block. Ids are
    1-based; ids above ``v_pad`` (the padding sentinels, or query ids beyond
    the corpus vocabulary) land in a spare column that is cut off. Ids are
    unique per row, so every kept cell is written once."""
    r = col.shape[0]
    out = torch.zeros((r, v_pad + 1), dtype=torch.float32, device=col.device)
    idx = torch.where((col >= 1) & (col <= v_pad), col.long() - 1, v_pad)
    out.scatter_(1, idx, val.float())
    return out[:, :v_pad]


def densify_t(col: torch.Tensor, val: torch.Tensor, v_pad: int) -> torch.Tensor:
    """:func:`densify` transposed to f32[v_pad, rows], contiguous: the table
    layout of :func:`dot_qdense`."""
    return densify(col, val, v_pad).t().contiguous()


#: Queries a tile of :class:`Postings` (``QT`` of csrc/sparse_qdense.cu): a
#: term's records are cut by tile, so the kernel's warp finds its tile's run
#: between two pointers
POST_TILE = 32


@dataclasses.dataclass(frozen=True)
class Postings:
    """A query batch's term-major postings over a padded vocabulary of ``v``
    ids: the query side of :func:`qdense_dists`.

    ``rec`` i32[R, 2] holds one (query index, value bits) record a slot of
    the batch, sorted by (id, query tile of :data:`POST_TILE`, query); the
    records of 0-based term t in tile j are ``rec[ptr[t * tiles + j]:ptr[t *
    tiles + j + 1]]``, ascending in query. ``ptr`` is i32[v * tiles + 1];
    records past ``ptr[-1]`` are the batch's padding and ids beyond the
    vocabulary, which no corpus id matches, and are never read. ``span``
    is the kernel's view of the runs: one 16-byte load gives a (term, tile)
    run's bounds and its first record, which is most runs' only one. Not a
    tensor, so an encoded batch's row slicing (seq_search._slice_qenc)
    leaves it whole; it records its ``nq`` and ``v`` for a check."""

    ptr: torch.Tensor
    rec: torch.Tensor
    nq: int
    v: int

    @property
    def tiles(self) -> int:
        return max(1, -(-self.nq // POST_TILE))

    @property
    def device(self) -> torch.device:
        return self.ptr.device

    @functools.cached_property
    def _checked(self) -> torch.device:
        """The postings' device, once their arrays are checked (at the first
        :func:`qdense_dists` call on them)."""
        dev = self.device
        _want("", "post.ptr", self.ptr, torch.int32, (self.v * self.tiles + 1,), dev)
        _want("", "post.rec", self.rec, torch.int32, (self.rec.shape[0], 2), dev)
        return dev

    @functools.cached_property
    def span(self) -> torch.Tensor:
        """The kernel's view of the runs, i32[v * tiles + 1, 4]: row k = t *
        tiles + j holds the run of term t in tile j as (start, length | q0 <<
        8 | q1 << 16, value 0, value 1), q0 and q1 the queries of its first
        two records less j * POST_TILE and their value bits (0 past the run's
        end); the last row an empty run (padding's). Most runs hold at most
        two records, so one 16-byte load gives all their products. Derived
        from ``ptr`` and ``rec`` at its first use, so that it always agrees
        with them."""
        ptr, rec = self.ptr.long(), self.rec
        start, n = ptr[:-1], ptr[1:] - ptr[:-1]
        base = (torch.arange(start.shape[0], device=ptr.device) % self.tiles) * POST_TILE
        padded = torch.cat((rec, rec.new_zeros((1, 2))))  # the zero row past the records
        r0 = padded[torch.where(n > 0, start, rec.shape[0])]
        r1 = padded[torch.where(n > 1, start + 1, rec.shape[0])]
        q0 = torch.where(n > 0, r0[:, 0] - base, 0)
        q1 = torch.where(n > 1, r1[:, 0] - base, 0)
        span = torch.stack((start, n | q0 << 8 | q1 << 16, r0[:, 1].long(), r1[:, 1].long()), dim=1)
        end = torch.stack((ptr[-1:], ptr.new_zeros(1), ptr.new_zeros(1), ptr.new_zeros(1)), dim=1)
        return torch.cat((span, end)).int()
def postings(col: torch.Tensor, val: torch.Tensor, v_pad: int) -> Postings:
    """The term-major postings of query rows ``col``/``val`` ([Q, T], ids
    1-based, padding PAD_Q) over ``v_pad`` ids, on their device with one
    stable sort of the (id, query) pairs and no host sync: the row-major
    slots are in query order, so the sort keeps each run ascending. Ids
    outside [1, v_pad] sort past the last pointer, as :func:`densify` drops
    them. Memory: 8 B a query slot and 20 B a (term, tile), 19 MB at 512
    queries over 60,032 ids."""
    nq, t = col.shape
    tiles = max(1, -(-nq // POST_TILE))
    dev = col.device
    q = torch.arange(nq, device=dev).repeat_interleave(t)
    ids = col.reshape(-1).long()
    key = torch.where((ids >= 1) & (ids <= v_pad), (ids - 1) * tiles + q // POST_TILE, v_pad * tiles)
    key, order = torch.sort(key, stable=True)
    rec = torch.stack((q[order].int(), val.reshape(-1).float()[order].view(torch.int32)), dim=1)
    ptr = torch.searchsorted(key, torch.arange(v_pad * tiles + 1, device=dev), out_int32=True)
    return Postings(ptr, rec.contiguous(), nq, v_pad)


def postings_table(post: Postings) -> torch.Tensor:
    """The densified query table f32[v, nq] that ``post`` holds: value for
    value the table :func:`densify_t` makes of the same query rows. Each
    record's term is found from ``ptr``; the dropped records land in a spare
    row that is cut off."""
    i = torch.arange(post.rec.shape[0], device=post.device)
    term = (torch.searchsorted(post.ptr.long(), i, right=True) - 1) // post.tiles
    table = torch.zeros((post.v + 1, post.nq), dtype=torch.float32, device=post.device)
    table[term.clamp_(max=post.v), post.rec[:, 0].long()] = post.rec[:, 1].view(torch.float32)
    return table[:post.v]


def _row_blocks(n: int, per_row: int, dev: torch.device):
    """Row ranges of at most ops/distance.block_elems / per_row rows."""
    step = max(1, block_elems(dev) // max(per_row, 1))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def dot_qdense(qd_t: torch.Tensor, xcol: torch.Tensor, xval: torch.Tensor) -> torch.Tensor:
    """Sparse dots f32[Q, C] of densified queries against CSR rows.

    qd_t f32[V, Q] (:func:`densify_t` of the queries), xcol i32[C, nnz],
    xval f32[C, nnz]. Each corpus element gathers its id's row of Q query
    values; one batched product per row block then contracts over nnz.
    Padded elements clamp to a real row, but their value is 0."""
    require_ieee_f32(qd_t)
    v, nq = qd_t.shape
    c, nnz = xcol.shape
    idx = (xcol.long() - 1).clamp_(0, v - 1)
    out = torch.empty((c, nq), dtype=torch.float32, device=qd_t.device)
    for s, e in _row_blocks(c, nnz * nq, qd_t.device):
        g = qd_t[idx[s:e].reshape(-1)].view(e - s, nnz, nq)
        out[s:e] = torch.bmm(xval[s:e, None, :].float(), g)[:, 0]
    return out.t()


def real_slots(col: torch.Tensor) -> torch.Tensor:
    """1.0 at the slots of real elements, 0.0 at padding (either sentinel)."""
    return ((col >= 1) & (col < PAD_X)).float()


def intersect_count_qdense(qp_t: torch.Tensor, xcol: torch.Tensor) -> torch.Tensor:
    """|A n B| f32[Q, C] against a densified query *presence* table
    f32[V, Q] (1.0 at the query's ids). Padded corpus slots clamp to a real
    row, so they are masked by their weight, not by the table."""
    return dot_qdense(qp_t, xcol, real_slots(xcol))


def gathered_dot(qd: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """dot[b, k] = sum_j qd[b, cols[b,k,j]] * vals[b,k,j]: each query's
    candidate rows [B, K, nnz] against its own row of a densified table
    f32[B, V]. Padded slots carry value 0."""
    b, k, nnz = cols.shape
    v = qd.shape[1]
    idx = (cols.reshape(b, k * nnz).long() - 1).clamp_(0, v - 1)
    q = torch.gather(qd, 1, idx).view(b, k, nnz)
    return row_dot(q, vals)


def gathered_found(qp: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """|A n B| f32[B, K] of each query against its own candidate rows, from
    a presence table f32[B, V]; padded slots masked explicitly."""
    return gathered_dot(qp, cols, real_slots(cols))


def _search(seq: torch.Tensor, targets: torch.Tensor):
    """For each target (sorted ``seq`` [*L, n], targets [*L, m]): the
    position of its equal element in ``seq`` clamped into range, and
    whether it is there (jnp.searchsorted side='left' as tpu_knn's
    _bsearch_first_geq)."""
    pos = torch.searchsorted(seq, targets, out_int32=True).clamp_(max=seq.shape[-1] - 1).long()
    return pos, torch.gather(seq, -1, pos) == targets


def lookup_query_vals(qcol: torch.Tensor, qval: torch.Tensor, xcol: torch.Tensor):
    """The query's value at each corpus element, and whether the query has
    that id: (vals f32, found bool), both shaped like ``xcol`` with the
    query axis in front where the rows are shared.

    Two layouts: a query batch against shared corpus rows (qcol [Q, T],
    xcol [C, nnz] -> [Q, C, nnz]), and each query against its own
    candidates (qcol [B, T], xcol [B, K, nnz] -> [B, K, nnz]). Values are 0
    where not found."""
    if xcol.ndim == 2:
        q, (c, nnz) = qcol.shape[0], xcol.shape
        targets = xcol.reshape(1, c * nnz).expand(q, c * nnz).contiguous()
        out_shape = (q, c, nnz)
    else:
        b, k, nnz = xcol.shape
        targets = xcol.reshape(b, k * nnz)
        out_shape = (b, k, nnz)
    pos, found = _search(qcol, targets)
    vals = torch.where(found, torch.gather(qval, -1, pos), 0.0)
    return vals.view(out_shape), found.view(out_shape)


def lookup_dot_blocked(qcol, qval, xcol, xval) -> torch.Tensor:
    """Dots f32[Q, C] of a query batch against shared corpus rows through
    the binary-search lookup (a corpus without the vocabulary gate), in
    row blocks that bound the [Q, C, nnz] lookup. With unit query values
    and :func:`real_slots` as ``xval`` it counts the intersections."""
    nq, (c, nnz) = qcol.shape[0], xcol.shape
    out = torch.empty((nq, c), dtype=torch.float32, device=xcol.device)
    for s, e in _row_blocks(c, nq * nnz * 4, xcol.device):
        vals, _ = lookup_query_vals(qcol, qval, xcol[s:e])
        out[:, s:e] = torch.sum(vals * xval[None, s:e], dim=-1)
    return out


def reverse_found(qcol: torch.Tensor, xcol: torch.Tensor) -> torch.Tensor:
    """found[i, j, s]: does corpus row j hold query i's element s. Layouts
    as :func:`lookup_query_vals`: [Q, C, T] for shared rows, [B, K, T] for
    each query's own candidates."""
    if xcol.ndim == 2:
        q, t = qcol.shape
        c = xcol.shape[0]
        _, found = _search(xcol, qcol.reshape(1, q * t).expand(c, q * t).contiguous())
        return found.view(c, q, t).transpose(0, 1)
    b, k, _ = xcol.shape
    _, found = _search(xcol, qcol[:, None, :].expand(b, k, qcol.shape[1]).contiguous())
    return found


def lp_union(vals, found, xval, p: float, q_pterm):
    """sum over the union of supports of |q_t - x_t|^p from a lookup
    (``vals``/``found`` of :func:`lookup_query_vals`, ``xval`` broadcast
    like them, ``q_pterm`` the per-query sum of |q|^p with the query axis
    first). Padded slots give |0 - 0|^p = 0."""
    ax = torch.abs(xval - vals)
    d = torch.where(ax > 0, ax**p, 0.0)
    qq = torch.where(found, torch.abs(vals) ** p, 0.0)
    return torch.sum(d - qq, dim=-1) + q_pterm


def linf_union(vals, xval, rfound, qval):
    """max over the union of supports of |q_t - x_t|: the corpus support
    through the lookup, the query-only ids (``rfound`` False) as |q_s|.
    ``qval`` is broadcast like ``rfound``."""
    m_x = torch.amax(torch.abs(xval - vals), dim=-1)
    m_q = torch.amax(torch.where(rfound, 0.0, torch.abs(qval)), dim=-1)
    return torch.maximum(m_x, m_q)


def lp_union_blocked(qcol, qval, xcol, xval, p: float, q_pterm):
    """Lp^p over the union of supports, f32[Q, C] (shared rows) or [B, K]
    (own candidates); row blocks bound the [Q, C, nnz] lookup."""
    if xcol.ndim == 3:
        vals, found = lookup_query_vals(qcol, qval, xcol)
        return lp_union(vals, found, xval, p, q_pterm[:, None])
    nq, (c, nnz) = qcol.shape[0], xcol.shape
    outs = []
    for s, e in _row_blocks(c, nq * nnz * 4, xcol.device):
        vals, found = lookup_query_vals(qcol, qval, xcol[s:e])
        outs.append(lp_union(vals, found, xval[None, s:e], p, q_pterm[:, None]))
    return torch.cat(outs, dim=1) if outs else qval.new_zeros((nq, 0))


def linf_union_blocked(qcol, qval, xcol, xval):
    """Linf over the union of supports, layouts as :func:`lp_union_blocked`."""
    if xcol.ndim == 3:
        vals, _ = lookup_query_vals(qcol, qval, xcol)
        rfound = reverse_found(qcol, xcol)
        return linf_union(vals, xval, rfound, qval[:, None, :])
    nq, (c, nnz) = qcol.shape[0], xcol.shape
    outs = []
    for s, e in _row_blocks(c, nq * (nnz + qcol.shape[1]) * 4, xcol.device):
        vals, _ = lookup_query_vals(qcol, qval, xcol[s:e])
        rfound = reverse_found(qcol, xcol[s:e])
        outs.append(linf_union(vals, xval[None, s:e], rfound, qval[:, None, :]))
    return torch.cat(outs, dim=1) if outs else qval.new_zeros((nq, 0))


def pair_lookup(acol, aval, bcol, bval):
    """For pairs of candidate rows of each batch row (a-side [B, C, nnz_a],
    b-side [B, C2, nnz_b], both sorted): the b-side value matching each
    a-side element, 0 where b lacks it, and whether it was found, both
    f32/bool[B, C, C2, nnz_a]."""
    b, c, na = acol.shape
    c2 = bcol.shape[1]
    targets = acol.reshape(b, 1, c * na).expand(b, c2, c * na).contiguous()
    pos, found = _search(bcol, targets)  # [B, C2, C*na]
    bv = torch.where(found, torch.gather(bval, -1, pos), 0.0)
    shape = (b, c2, c, na)
    return bv.view(shape).transpose(1, 2), found.view(shape).transpose(1, 2)


def _seq_sum(a, m) -> torch.Tensor:
    """sum_i a[..., i] * m[..., i], added in slot order from 0 with one
    fused multiply-add a slot (``addcmul`` rounds once)."""
    acc = torch.zeros(m.shape[:-1], dtype=torch.float32, device=m.device)
    for i in range(m.shape[-1]):
        acc = torch.addcmul(acc, a[..., i], m[..., i])
    return acc


def pair_dots(acol, aval, bcol, bval) -> torch.Tensor:
    """Pairwise dots [B, C, C2] of per-row candidate sets (a gram matrix
    when both sides are the same candidates), in row blocks."""
    b, c, na = acol.shape
    c2 = bcol.shape[1]
    out = torch.empty((b, c, c2), dtype=torch.float32, device=acol.device)
    for s, e in _row_blocks(b, c * c2 * na * 4, acol.device):
        bv, _ = pair_lookup(acol[s:e], aval[s:e], bcol[s:e], bval[s:e])
        out[s:e] = row_dot(aval[s:e, :, None, :].float(), bv)
    return out


def pair_intersect(acol, bcol) -> torch.Tensor:
    """Pairwise |A n B| [B, C, C2] of per-row candidate sets (padding never
    matches: the a-side's real-slot weight masks it)."""
    b, c, na = acol.shape
    c2 = bcol.shape[1]
    areal = real_slots(acol)
    out = torch.empty((b, c, c2), dtype=torch.float32, device=acol.device)
    for s, e in _row_blocks(b, c * c2 * na * 4, acol.device):
        _, found = pair_lookup(acol[s:e], areal[s:e], bcol[s:e], real_slots(bcol[s:e]))
        out[s:e] = row_dot(areal[s:e, :, None, :], found.float())
    return out


def pair_lp(acol, aval, bcol, bval, p: float, a_pterm) -> torch.Tensor:
    """Pairwise Lp^p over the union of supports [B, C, C2]: the a-side plays
    the query (its per-row |a|^p sums ``a_pterm`` [B, C])."""
    b, c, _ = acol.shape
    c2, nb = bcol.shape[1], bcol.shape[2]
    out = torch.empty((b, c, c2), dtype=torch.float32, device=acol.device)
    for s, e in _row_blocks(b, c * c2 * nb * 4, acol.device):
        # the b-side elements looked up in the a-side rows
        av, found = pair_lookup(bcol[s:e], bval[s:e], acol[s:e], aval[s:e])  # [B, C2, C, nb]
        xv = bval[s:e, :, None, :]
        out[s:e] = lp_union(av, found, xv, p, a_pterm[s:e, None, :]).transpose(1, 2)
    return out


def pair_linf(acol, aval, bcol, bval) -> torch.Tensor:
    """Pairwise Linf over the union of supports [B, C, C2]."""
    b, c, na = acol.shape
    c2, nb = bcol.shape[1], bcol.shape[2]
    out = torch.empty((b, c, c2), dtype=torch.float32, device=acol.device)
    for s, e in _row_blocks(b, c * c2 * (na + nb) * 4, acol.device):
        av, _ = pair_lookup(bcol[s:e], bval[s:e], acol[s:e], aval[s:e])  # [B, C2, C, nb]
        _, rfound = pair_lookup(acol[s:e], aval[s:e], bcol[s:e], bval[s:e])  # [B, C, C2, na]
        m_x = torch.amax(torch.abs(bval[s:e, :, None, :] - av), dim=-1).transpose(1, 2)
        m_q = torch.amax(torch.where(rfound, 0.0, torch.abs(aval[s:e, :, None, :])), dim=-1)
        out[s:e] = torch.maximum(m_x, m_q)
    return out


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a * b in f32 (broadcast). On the CPU one
    fused multiply-add a slot, in slot order: the order of tpu_knn's
    fori_loop over the a-side slots of a pair dot (XLA contracts it into
    FMAs), and the order XLA's CPU code gives its short reductions over
    nnz (16 and 24 slots checked), so the scores there, and the graphs
    built on them, equal tpu_knn's. On the card one reduction kernel: the
    same products summed in another order, where a slot loop would add nnz
    launches to every beam step and pair block."""
    if a.device.type != "cpu":
        return torch.sum(a * b, dim=-1)
    return _seq_sum(a, b)


def norms_from_vals(vals: torch.Tensor) -> torch.Tensor:
    """Row L2 norms of padded CSR values (padding is 0)."""
    return torch.sqrt(row_dot(vals, vals))


def jaccard_from_counts(inter, alen, blen):
    """1 - |A n B| / |A u B| from an intersection count and the two
    support sizes (broadcast); 0 where both sets are empty."""
    union = alen + blen - inter
    return torch.where(union > 0, 1.0 - inter / torch.clamp_min(union, 1.0), 0.0)


#: The forms of :func:`qdense_dists`, in the kernel's numbering: the dot
#: spaces' posts (:func:`dot_post`) and Jaccard's
QDENSE_FORMS = ("negdot", "querynorm", "cosine", "angular", "jaccard")
#: the norm floor of the normalized forms (NormScalarProduct's)
TINY = 1e-10


def dot_post(form: str, dot, qn, xn):
    """A dot space's distance from its dots and the query and row norms
    (broadcast): ``negdot`` -dot, ``querynorm`` -dot/|q|, ``cosine``
    max(0, 1 - cos), ``angular`` acos(clip(cos, -1, 1)), cos = dot /
    max(|q||x|, TINY) (reference: src/distcomp_scalar.cc)."""
    if form == "negdot":
        return -dot
    if form == "querynorm":
        return -dot / torch.clamp_min(qn, TINY)
    cos = dot / torch.clamp_min(qn * xn, TINY)
    if form == "cosine":
        return torch.clamp_min(1.0 - cos, 0.0)
    if form == "angular":
        return torch.arccos(torch.clamp(cos, -1.0, 1.0))
    raise ValueError(f"unknown dot form {form!r}; known: {QDENSE_FORMS[:4]}")


def qdense_dists_reference(form, post, xcol, w, qn, qlen, xlen, pad) -> torch.Tensor:
    """Plain version of :func:`qdense_dists`: the postings' table
    (:func:`postings_table`), :func:`dot_qdense` (or
    :func:`intersect_count_qdense` for ``jaccard``), then the form's post,
    then ``pad``."""
    table = postings_table(post)
    if form == "jaccard":
        d = jaccard_from_counts(intersect_count_qdense(table, xcol), qlen[:, None], xlen[None, :])
    else:
        xn = norms_from_vals(w)[None, :] if form in ("cosine", "angular") else None
        d = dot_post(form, dot_qdense(table, xcol, w), None if qn is None else qn[:, None], xn)
    return d + pad[None, :]


def _want(form, name, t, dtype, shape, dev) -> None:
    """Raises unless ``t`` is a ``dtype`` tensor on ``dev`` of ``shape``
    (any shape for None)."""
    if t is None or t.dtype != dtype or t.device != dev or (shape is not None and t.shape != shape):
        got = "None" if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
        raise ValueError(f"qdense_dists {form}: {name} must be {dtype} {shape or ''} on {dev}; got {got}")


def _check_qdense(form, post, xcol, w, qn, qlen, xlen, pad) -> None:
    """The wrapper's contract, checked at every call: a scan makes one a
    chunk, so a batch's postings are checked once (``Postings._checked``)."""
    if form not in QDENSE_FORMS:
        raise ValueError(f"qdense_dists: unknown form {form!r}; known: {list(QDENSE_FORMS)}")
    if not isinstance(post, Postings) or xcol.ndim != 2:
        raise ValueError(f"qdense_dists needs Postings and xcol [C, nnz]; got {type(post).__name__}, "
                         f"{tuple(xcol.shape)}")
    dev = post._checked
    nq, (c, nnz) = post.nq, xcol.shape
    _want(form, "xcol", xcol, torch.int32, None, dev)
    _want(form, "pad", pad, torch.float32, (c,), dev)
    if form == "jaccard":
        _want(form, "qlen", qlen, torch.int32, (nq,), dev)
        _want(form, "xlen", xlen, torch.int32, (c,), dev)
    else:
        _want(form, "w", w, torch.float32, (c, nnz), dev)
        if form != "negdot":
            _want(form, "qn", qn, torch.float32, (nq,), dev)


def _qdense_launch(form, post, xcol, w, qn, qlen, xlen, pad) -> torch.Tensor:
    """One launch of csrc/sparse_qdense.cu on CUDA tensors; raises if the
    tensors are not on the card or the launch is refused."""
    if post.device.type != "cuda":
        raise ValueError(f"qdense_dists: the kernel runs on a CUDA tensor; got one on {post.device}")
    args = (post.span, post.rec, xcol, w, qn, qlen, xlen, pad)
    if any(t is not None and not t.is_contiguous() for t in args):
        raise ValueError("qdense_dists: every tensor must be contiguous")
    c, nnz = xcol.shape
    out = torch.empty((post.nq, c), dtype=torch.float32, device=post.device)
    if post.nq == 0 or c == 0:
        return out
    lib = _qdense_lib()
    ptr = [None if t is None else t.data_ptr() for t in args]
    dev = post.device
    # the launch goes to the current device: switch only when the postings lie elsewhere
    with torch.cuda.device(dev) if torch.cuda.current_device() != dev.index else contextlib.nullcontext():
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tk_sparse_qdense(QDENSE_FORMS.index(form), ptr[0], ptr[1], post.v, post.nq, ptr[2], ptr[3], c, nnz,
                                   *ptr[4:], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sparse_qdense {form} kernel launch failed: {lib.tk_error_string(err).decode()} ({err})")
    GM.count_launch(f"sparse_qdense_{form}")
    return out


@functools.lru_cache(maxsize=None)
def _qdense_lib():
    """The kernel's library (built by ops/groupmin.py with the others), its
    entry typed, once."""
    lib = GM._load("sparse_qdense")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tk_sparse_qdense.argtypes = [ci, vp, vp, i64, i64, vp, vp, i64, ci, vp, vp, vp, vp, vp, vp]
    lib.tk_sparse_qdense.restype = ci
    return lib


def qdense_dists(form: str, post, xcol, w, qn, qlen, xlen, pad) -> torch.Tensor:
    """Distances f32[Q, C] of a query batch against shared corpus rows:
    ``post(sum_t table[col[r,t]-1, q] w[r,t]) + pad[r]`` for the table
    that the batch's postings hold.

    ``post`` the batch's :class:`Postings` (:func:`postings`; presence
    values for ``jaccard``), ``xcol`` i32[C, nnz] (padding carries weight
    0), ``w`` the corpus values f32[C, nnz] (the dot forms), ``qn`` the
    query norms f32[Q] (``querynorm``, ``cosine``, ``angular``),
    ``qlen``/``xlen`` the support sizes i32[Q]/[C] (``jaccard``), ``pad``
    f32[C]; what a form does not read may be None. ``form`` is one of
    :data:`QDENSE_FORMS`.

    A CPU tensor runs :func:`qdense_dists_reference`. A CUDA tensor
    launches ``csrc/sparse_qdense.cu`` (counted in ops/groupmin.py's
    ``launches`` as ``sparse_qdense_{form}``) or raises; it never falls
    back."""
    _check_qdense(form, post, xcol, w, qn, qlen, xlen, pad)
    if post.device.type == "cpu":
        return qdense_dists_reference(form, post, xcol, w, qn, qlen, xlen, pad)
    return _qdense_launch(form, post, xcol, w, qn, qlen, xlen, pad)


def sketch_matrix(v_pad: int, dsk: int, seed: int, device="cpu") -> torch.Tensor:
    """Seeded Gaussian random-projection matrix f32[v_pad, dsk], scaled
    1/sqrt(dsk) so E[<Rq, Rx>] = <q, x> (Johnson-Lindenstrauss): the matrix
    tpu_knn draws, jax.random.normal(PRNGKey(uint32(seed)), (v_pad, dsk))
    / sqrt(dsk), drawn without jax (utils/rng.py jax_normal). A saved index
    stores only the seed; the matrix is drawn again on load."""
    return jax_normal(seed, (v_pad, dsk), device) * (1.0 / dsk**0.5)


def sketch_csr(col, val, r_mat: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Project padded-CSR rows through R: f32[N, dsk]. Each chunk of rows is
    densified over the padded vocabulary and multiplied with R once; the
    transient [chunk, v_pad] block bounds memory. ``val`` carries any
    per-space normalization (unit rows for the cosine family, presence
    indicators for jaccard)."""
    require_ieee_f32(r_mat)
    n = col.shape[0]
    v_pad = r_mat.shape[0]
    out = torch.empty((n, r_mat.shape[1]), dtype=torch.float32, device=r_mat.device)
    for s in range(0, n, chunk):
        out[s:s + chunk] = densify(col[s:s + chunk], val[s:s + chunk], v_pad) @ r_mat
    return out
