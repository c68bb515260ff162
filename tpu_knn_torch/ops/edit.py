"""Batched Levenshtein distance (counterpart of tpu_knn/ops/edit.py;
reference: include/distcomp_edist.h, src/distcomp_edist.cc, a per-pair
O(L1*L2) dynamic program).

One DP over a whole block of string pairs at once. The row recurrence

    D[i][j] = min(D[i-1][j] + 1, D[i][j-1] + 1, D[i-1][j-1] + cost)

is sequential in j through D[i][j-1]; it unrolls to a prefix min,

    D[i][j] = min_{k <= j} (E[k] + (j - k)),
    E[j]    = min(D[i-1][j] + 1, D[i-1][j-1] + cost_j),  E[0] = i,

so a row is one ``torch.cummin`` over the query axis (tpu_knn's
``lax.associative_scan(jnp.minimum)``), and the loop over corpus
characters (tpu_knn's ``lax.scan``) is a host loop of a few torch ops a
character. The carry is kept shifted, V[j] = D[i][j] - j + i, which turns
the recurrence into

    V'[j] = cummin_k min(V[k] + 2, V[k-1] + cost_k),  V'[0] = 2i,

with no per-step column offsets; D[i][len(q)] = V[len(q)] - i + len(q).
A pair's answer is read at the step where its corpus string ends, so no
step masks the carry. Cells beyond len(q) never reach the answer column
(D[i][j] depends only on j' <= j), so character padding is irrelevant.

The carry is laid out with the query-position axis first, [Lq+1, *B], so
every op of a step reads and writes contiguous rows of B pairs, and the
prefix min runs along the outer axis: ``torch.cummin(dim=0)`` on a card
(one thread per pair walking its column; ``cummin`` along a short
innermost axis measured ~20x slower there), a loop of Lq ``torch.minimum``
over contiguous rows on the CPU (3.6x faster there than ``cummin``).

Every value is an exact int32, so the result is tpu_knn's whatever the
order of operations, and independent of how the pairs are blocked: the
blocked form splits the corpus (and, if it must, the queries) so that one
carry holds at most ``ops/distance.block_elems`` elements.
"""

from __future__ import annotations

import torch

from .distance import block_elems


def _prefix_min(e: torch.Tensor) -> torch.Tensor:
    """Running min along axis 0: a new tensor on a card, ``e`` itself
    (overwritten) on the CPU."""
    if e.device.type == "cuda":
        return torch.cummin(e, dim=0).values
    for j in range(1, e.shape[0]):
        torch.minimum(e[j], e[j - 1], out=e[j])
    return e


def _edit_dp(qchars, qlen, xchars, xlen) -> torch.Tensor:
    """Edit distances i32[B] of broadcast pairs: ``qchars`` i32[*Bq, Lq]
    with ``qlen`` i32[*Bq], ``xchars`` i32[*Bx, Lx] with ``xlen`` i32[*Bx],
    where Bq and Bx broadcast to B."""
    lq, lx = qchars.shape[-1], xchars.shape[-1]
    shape = torch.broadcast_shapes(qchars.shape[:-1], xchars.shape[:-1])
    dev = qchars.device
    qt = qchars.movedim(-1, 0)  # [Lq, *Bq]
    ql = qlen.clamp(0, lq)
    # a corpus string of length 0: D[0][len(q)] = len(q)
    res = torch.broadcast_to(ql, shape).clone()
    take = torch.broadcast_to(ql.long()[None], (1,) + shape)
    v = torch.zeros((lq + 1,) + shape, dtype=torch.int32, device=dev)
    e = torch.empty_like(v)
    for t in range(lx):
        ne = qt != xchars[..., t]  # cost_j, [Lq, *B]
        torch.add(v[:-1], ne, out=e[1:])
        v[1:] += 2  # the old carry is dead after this step
        torch.minimum(e[1:], v[1:], out=e[1:])
        e[0] = 2 * (t + 1)
        new = _prefix_min(e)
        v, e = new, (v if new is e else e)
        d = v.gather(0, take)[0] - (t + 1) + ql
        res = torch.where(xlen == t + 1, d, res)
    return res


def levenshtein_blocked(
    qchars: torch.Tensor,  # i32[Q, Lq]
    qlen: torch.Tensor,  # i32[Q]
    xchars: torch.Tensor,  # i32[C, Lx]
    xlen: torch.Tensor,  # i32[C]
) -> torch.Tensor:
    """Edit distances i32[Q, C] between every query/corpus string pair."""
    nq, lq = qchars.shape
    nc = xchars.shape[0]
    out = torch.empty((nq, nc), dtype=torch.int32, device=xchars.device)
    if nq == 0 or nc == 0:
        return out
    cap = block_elems(xchars.device)
    qstep = max(1, min(nq, cap // (lq + 1)))
    cstep = max(1, cap // (qstep * (lq + 1)))
    for q0 in range(0, nq, qstep):
        q1 = min(q0 + qstep, nq)
        qc, ql = qchars[q0:q1, None, :], qlen[q0:q1, None]
        for c0 in range(0, nc, cstep):
            c1 = min(c0 + cstep, nc)
            out[q0:q1, c0:c1] = _edit_dp(qc, ql, xchars[None, c0:c1], xlen[None, c0:c1])
    return out


def levenshtein_gathered(qchars, qlen, xchars, xlen) -> torch.Tensor:
    """Edit distances i32[B, K] of query b against its own rows: ``qchars``
    i32[B, Lq], ``xchars`` i32[B, K, Lx] (the graph's gathered candidates),
    in row blocks of at most ``block_elems`` carry elements."""
    b, k = xchars.shape[:2]
    out = torch.empty((b, k), dtype=torch.int32, device=xchars.device)
    step = max(1, block_elems(xchars.device) // max(k * (qchars.shape[-1] + 1), 1))
    for b0 in range(0, b, step):
        b1 = min(b0 + step, b)
        out[b0:b1] = _edit_dp(qchars[b0:b1, None, :], qlen[b0:b1, None], xchars[b0:b1], xlen[b0:b1])
    return out


def levenshtein_pairs(qchars, qlen, xchars, xlen) -> torch.Tensor:
    """Edit distances i32[B, C, C2] of per-row candidate sets: the a side
    ``qchars`` i32[B, C, Lq] against ``xchars`` i32[B, C2, Lx] (the
    construction heuristic's pairs), in row blocks."""
    b, c, lq = qchars.shape
    c2 = xchars.shape[1]
    out = torch.empty((b, c, c2), dtype=torch.int32, device=xchars.device)
    step = max(1, block_elems(xchars.device) // max(c * c2 * (lq + 1), 1))
    for b0 in range(0, b, step):
        b1 = min(b0 + step, b)
        out[b0:b1] = _edit_dp(qchars[b0:b1, :, None, :], qlen[b0:b1, :, None],
                              xchars[b0:b1, None], xlen[b0:b1, None])
    return out


def normalize(d: torch.Tensor, qlen: torch.Tensor, xlen: torch.Tensor) -> torch.Tensor:
    """leven / max(len1, len2) in f32, 0 when both are empty (reference:
    space_leven.h:57-68 SpaceLevenshteinNormalized); ``qlen`` and ``xlen``
    broadcast against ``d``. One IEEE division, so tpu_knn's bits."""
    denom = torch.maximum(qlen, xlen).to(torch.float32)
    return torch.where(denom > 0, d.to(torch.float32) / torch.clamp_min(denom, 1.0), 0.0)


def normalized_levenshtein_blocked(qchars, qlen, xchars, xlen) -> torch.Tensor:
    """leven / max(len1, len2) f32[Q, C]; 0 when both strings are empty."""
    d = levenshtein_blocked(qchars, qlen, xchars, xlen)
    return normalize(d, qlen[:, None], xlen[None, :])
