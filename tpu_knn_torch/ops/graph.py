"""Gather-and-score primitives used by pass 2 of the exact scan
(counterpart of the group-gather part of tpu_knn/ops/graph.py).

Only what pass 2 runs is ported: the 128-row group gather, the row-term
recompute and the affine (one batched matmul) scorer. The generic
per-query scorer, the sparse scorer and the graph-search loops come with
the HNSW slice.
"""

from __future__ import annotations

import torch

from .topk import INF


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
    """Distances of query b to its pre-gathered candidate rows [B,K,D]:
    one batched f32 matmul (exact for int8 rows, ops/distance.batched_dot)
    + the exact post-transform, for spaces with an affine factored form
    (space.pass1_affine)."""
    extra_sl = inject_term(space, rows, extra_sl)
    aff = space.pass1_affine() if hasattr(space, "pass1_affine") else None
    if aff is None or rows.ndim != 3:
        raise NotImplementedError(
            f"score_gathered: only affine-factored dense spaces are ported; got {space.name!r}"
        )
    from .distance import batched_dot

    scale, sq, sx = aff
    g = batched_dot(qenc["q"], rows)
    s = scale * g
    if sq != 0.0 and "q_term" in qenc:
        s = s + sq * qenc["q_term"][:, None]
    if sx != 0.0 and "x_term" in extra_sl:
        s = s + sx * extra_sl["x_term"]
    return space.pass1_post(s, qenc) + pad
