"""Blocked dense distance primitives (counterpart of tpu_knn/ops/distance.py).

Almost every NMSLIB distance factors through a matmul:

    dist[i, j] = post( scale * <A(q_i), B(x_j)>  +  a(q_i) + b(x_j) + const )

with per-space element transforms A/B and per-row terms a/b precomputed
once at encode time (l2sqr: |q|^2 + |x|^2 - 2 q.x; cosinesimil: 1 - qn.xn
over pre-normalized rows). Every product here is an IEEE f32 matmul;
int8 operands (l2sqr_sift) are cast to f32 first, which is exact (see
:func:`int8_dot`). :func:`matmul` takes tpu_knn's precision names:

  ``"float32"``   one f32 matmul (the exact/gold path);
  ``"high"``      bf16x3: hi.hi + (hi.lo + lo.hi) of the bf16 splits of
                  both operands, each an f32 matmul of bf16-rounded values;
  ``"bfloat16"``  both operands rounded to bf16, one f32 matmul: exact
                  products, f32 accumulation.

The reduced tiers share ops/groupmin.py's ``_tier_dot`` with the pass-1
kernels' plain versions; none of them is a bf16 matmul, whose output
torch rounds to bf16. On CUDA every product needs
``torch.backends.cuda.matmul.allow_tf32`` False and the float32 matmul
precision "highest" (PyTorch's defaults); the functions refuse to run
otherwise rather than return TF32 distances, which keep about three
decimal digits and reorder near neighbours.
"""

from __future__ import annotations

from typing import Callable

import torch

from .groupmin import PRECISIONS, _tier_dot


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; known: {list(PRECISIONS)}")


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
    """[Q,D] @ [C,D]^T -> f32[Q,C] at ``precision`` (module docstring)."""
    check_precision(precision)
    require_ieee_f32(q)
    return _tier_dot(q, x, precision)


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


# ---------------- concrete factored families ----------------


def l2sqr_blocked(q, x, q_sq=None, x_sq=None, precision="float32"):
    """Squared L2 via the norm identity."""
    q_sq = sq_norms(q) if q_sq is None else q_sq
    x_sq = sq_norms(x) if x_sq is None else x_sq
    return torch.clamp_min(factored(q, x, q_sq, x_sq, scale=-2.0, precision=precision), 0.0)


def l2_blocked(q, x, q_sq=None, x_sq=None, precision="float32"):
    return torch.sqrt(l2sqr_blocked(q, x, q_sq, x_sq, precision))


def cosine_blocked(qn, xn, precision="float32"):
    """1 - cos over pre-normalized rows (reference: space_scalar.h
    NormCosine)."""
    return torch.clamp_min(factored(qn, xn, scale=-1.0, const=1.0, precision=precision), 0.0)


def angular_blocked(qn, xn, precision="float32"):
    """arccos of the cosine of pre-normalized rows, clipped to [-1, 1]
    first: f32 rounding can carry a cosine just past 1."""
    return torch.arccos(torch.clamp(matmul(qn, xn, precision), -1.0, 1.0))


def negdot_blocked(q, x, precision="float32"):
    return factored(q, x, scale=-1.0, precision=precision)
