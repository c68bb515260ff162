"""Top-k primitives (counterpart of tpu_knn/ops/topk.py): the replacement
for the reference's KNNQueue / SortArrBI, plus a streaming merge so a
full corpus scan never materializes more than one [Q, chunk] block.

Tie order matters for parity with tpu_knn: ``jax.lax.top_k`` returns the
lower index first among equal values, and ``torch.topk`` promises no
order on ties. :func:`smallest_k` therefore takes a stable sort, which
gives exactly lax.top_k's order; callers use it on narrow blocks. A NaN
distance ranks FIRST, as ``lax.top_k(-d)`` ranks it: a corpus row that
holds +inf gives ``inf - inf`` under the l2 norm identity, and tpu_knn
returns that row first with distance NaN.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

#: Sentinel used for masked/padded candidates.
INF = float(np.inf)


def smallest_k(dists: torch.Tensor, k: int, idx: torch.Tensor | None = None, nan_free: bool = False):
    """Per-row k smallest entries, ascending, ties by lowest column, NaN
    entries first (by lowest column among themselves).
    Returns (dists[Q,k], ids[Q,k]).

    ``idx``: optional [Q, N] (or [N]) global ids to return instead of column
    positions.

    The order is that of ``lax.top_k(-dists, k)``: a stable descending sort
    of the negated distances, in which torch, like lax.top_k, treats NaN as
    the greatest value. ``nan_free``: the caller has masked every NaN away
    (the range scan's ``d <= radius``); a stable ascending sort then gives
    the same order without the negation pass over a wide block.
    """
    if nan_free:
        vals, pos = torch.sort(dists, dim=-1, stable=True)
        vals, pos = vals[..., :k], pos[..., :k]
    else:
        neg, pos = torch.sort(-dists, dim=-1, descending=True, stable=True)
        vals, pos = -neg[..., :k], pos[..., :k]
    if idx is None:
        ids = pos
    elif idx.ndim == 1:
        ids = idx[pos]
    else:
        ids = torch.gather(idx, -1, pos)
    return vals, ids


def merge_topk(d_a, i_a, d_b, i_b, k: int, nan_free: bool = False):
    """Merge two per-row top-k sets into one (ascending). This is the
    shard/thread merge of the reference (seqsearch.cc:163-176)."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    return smallest_k(d, k, i, nan_free)


def streaming_smallest_k(
    chunk_dists: Callable[[int], torch.Tensor],
    num_chunks: int,
    chunk_size: int,
    num_queries: int,
    k: int,
    device: torch.device | str = "cpu",
    nan_free: bool = False,
):
    """Scan ``num_chunks`` corpus chunks, keeping a running top-k.

    ``chunk_dists(ci)`` must return the [Q, chunk_size] distance block for
    chunk ``ci`` (with padded corpus rows already set to +inf). Device
    memory stays at one [Q, chunk] block + O(k) state. Running entries come
    before the chunk's in the merge, so ties keep the lowest column.
    ``nan_free``: no block holds a NaN (see :func:`smallest_k`).
    """
    fd = torch.full((num_queries, k), INF, dtype=torch.float32, device=device)
    fi = torch.full((num_queries, k), -1, dtype=torch.int64, device=device)
    cols = torch.arange(chunk_size, device=device).expand(num_queries, chunk_size)
    for ci in range(num_chunks):
        d = chunk_dists(ci)  # [Q, C]
        fd, fi = merge_topk(fd, fi, d, cols + ci * chunk_size, k, nan_free)
    return fd, fi


def mask_padding(dists: torch.Tensor, count: int, total: int) -> torch.Tensor:
    """Set distance columns >= count (corpus padding rows) to +inf."""
    cols = torch.arange(total, device=dists.device)[None, :]
    return torch.where(cols < count, dists, INF)


#: Row-group width of the two-pass exact top-k. The group-min containment
#: theorem behind the two-pass scan: if entry e is among the k smallest
#: overall, fewer than k groups have a min below e's group min (each such
#: group would contribute an element smaller than e), so e's group is among
#: the k smallest group mins: one top-k over the [Q, N/128] mins selects
#: <= k+margin groups whose k*128 columns provably contain the exact
#: answer. The pipeline lives in methods/seq_search.py with the fused
#: pass-1 kernel in ops/groupmin.py.
GROUP = 128
