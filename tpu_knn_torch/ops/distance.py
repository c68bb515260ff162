"""Blocked dense distance primitives (counterpart of tpu_knn/ops/distance.py).

Almost every NMSLIB distance factors through a matmul:

    dist[i, j] = post( scale * <A(q_i), B(x_j)>  +  a(q_i) + b(x_j) + const )

with per-space element transforms A/B and per-row terms a/b precomputed
once at encode time (l2sqr: |q|^2 + |x|^2 - 2 q.x). Every product here is
a full IEEE f32 matmul; int8 operands (l2sqr_sift) are cast to f32 first,
which is exact (see :func:`int8_dot`). On CUDA that
needs ``torch.backends.cuda.matmul.allow_tf32`` False and the float32
matmul precision "highest" (PyTorch's defaults); the functions refuse to
run otherwise rather than return TF32 distances, which keep about three
decimal digits and reorder near neighbours.
"""

from __future__ import annotations

from typing import Callable

import torch


def check_precision(precision: str) -> None:
    if precision != "float32":
        raise NotImplementedError(
            f"precision {precision!r}: only the float32 tier is ported "
            "(ROADMAP.md, TPU kernels to port)"
        )


def require_ieee_f32(t: torch.Tensor) -> None:
    """Raise unless f32 matmuls on ``t``'s device run in full IEEE f32."""
    if t.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "exact f32 distances need IEEE f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


def matmul(q: torch.Tensor, x: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """[Q,D] @ [C,D]^T -> f32[Q,C] in full IEEE f32."""
    check_precision(precision)
    require_ieee_f32(q)
    return q @ x.T


def factored(
    q: torch.Tensor,
    x: torch.Tensor,
    q_term: torch.Tensor | None = None,
    x_term: torch.Tensor | None = None,
    scale: float = 1.0,
    const: float = 0.0,
    post: Callable[[torch.Tensor], torch.Tensor] | None = None,
    precision: str = "float32",
) -> torch.Tensor:
    """The general matmul-factored distance block: see module docstring."""
    g = matmul(q, x, precision)
    if scale != 1.0:
        g = g * scale
    if q_term is not None:
        g = g + q_term[:, None]
    if x_term is not None:
        g = g + x_term[None, :]
    if const != 0.0:
        g = g + const
    return post(g) if post is not None else g


def int8_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """<q_i, x_j> of int8 rows as f32[Q, C], exact. Torch has no int8
    matmul on CUDA (and on the CPU it returns int8, wrapped), so the
    operands are cast to f32: every product is an integer of magnitude at
    most 2^14 and every partial sum of D <= 1024 of them below 2^24, exact
    in IEEE f32 in any order (TF32 off)."""
    require_ieee_f32(q)
    return q.float() @ x.float().T


def batched_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """<q_b, rows_bk> as f32[B, K], full IEEE f32. int8 inputs take the
    exact path of :func:`int8_dot` (tpu_knn's i32 accumulation)."""
    require_ieee_f32(q)
    if q.dtype == torch.int8:
        q, rows = q.float(), rows.float()
    return torch.bmm(rows, q[:, :, None])[:, :, 0]


def sq_norms(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)
