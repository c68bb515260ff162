"""Blocked dense distance primitives (counterpart of tpu_knn/ops/distance.py).

Almost every NMSLIB distance factors through a matmul:

    dist[i, j] = post( scale * <A(q_i), B(x_j)>  +  a(q_i) + b(x_j) + const )

with per-space element transforms A/B and per-row terms a/b precomputed
once at encode time (l2sqr: |q|^2 + |x|^2 - 2 q.x; cosinesimil: 1 - qn.xn
over pre-normalized rows; KL(q||x): sum q log q - q . log x; Itakura-Saito:
q . (1/x) - sum log q + sum log x - d; Renyi_a: 1/(a-1) log(q^a . x^(1-a));
alpha-beta: a product of elementwise powers plus row sums). The distances
that do not factor (L1, Linf, generic Lp, Jensen-Shannon) take the blocked
elementwise path :func:`elementwise_blocked`, plain torch ops with one
reduction over D per distance. Every product here is an IEEE f32 matmul;
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


def pair_dot(qa: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """<qa_bc, rows_be> as f32[B, C, E] (same dtype dispatch as
    :func:`batched_dot`)."""
    require_ieee_f32(qa)
    if qa.dtype == torch.int8:
        qa, rows = qa.float(), rows.float()
    return torch.bmm(qa, rows.transpose(1, 2))


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


def kldiv_blocked(q, log_x, q_logq_sum, precision="float32"):
    """KL(q||x) = sum q log q - q . log x, with ``log_x`` precomputed at
    encode (reference layout analog: distcomp.h:99-154 precomputed logs)."""
    return factored(q, log_x, q_term=q_logq_sum, scale=-1.0, precision=precision)


def itakura_saito_blocked(q, inv_x, logq_sum, logx_sum, dim, precision="float32"):
    """IS(q,x) = q.(1/x) - sum log q + sum log x - d."""
    return factored(
        q, inv_x, q_term=-logq_sum, x_term=logx_sum, const=-float(dim), precision=precision
    )


def renyi_blocked(q_a, x_1a, alpha, precision="float32"):
    """Renyi_a(q||x) = 1/(a-1) * log( sum q^a x^(1-a) )."""
    g = torch.clamp_min(matmul(q_a, x_1a, precision), 1e-30)
    return torch.log(g) / (alpha - 1.0)


def abdiv_blocked(q_a, x_b, q_ab_sum, x_ab_sum, alpha, beta, precision="float32"):
    """Alpha-beta divergence (Cichocki et al.; reference:
    src/distcomp_diverg.cc): for a,b != 0, a+b != 0:
      AB(q,x) = -1/(a*b) sum[ q^a x^b - a/(a+b) q^(a+b) - b/(a+b) x^(a+b) ]
    The cross term is a matmul of elementwise powers; the rest are row sums.
    """
    s = alpha + beta
    cross = matmul(q_a, x_b, precision)
    val = cross - (alpha / s) * q_ab_sum[:, None] - (beta / s) * x_ab_sum[None, :]
    return -val / (alpha * beta)


# ---------------- blocked elementwise path ----------------

def block_elems(dev: torch.device) -> int:
    """Elements one materialized intermediate of the elementwise distances
    may hold ([Q, chunk, D] here; [rows, queries, candidates, D] in the
    vmapped scorers of ops/graph.py, where XLA fuses them away): 512 MiB
    of f32 on a card, where larger blocks mean fewer launches, 4 MiB on
    the CPU. Every distance is reduced over D on its own, so the blocking
    changes no result."""
    return 1 << 27 if dev.type == "cuda" else 1 << 20


def elementwise_blocked(
    fn: Callable[..., torch.Tensor],
    q: torch.Tensor | tuple,
    x: torch.Tensor | tuple,
    reduce: str = "sum",
    chunk: int = 256,
) -> torch.Tensor:
    """dist[i,j] = reduce_d fn(q[i,d], x[j,d]) computed in corpus chunks to
    bound the [Q, chunk, D] intermediate: L1/Linf/Lp/JS and the other
    distances that do not factor through a product (reference per-pair
    loops in distcomp_lp.cc, distcomp_js.cc). ``q`` and ``x`` may be
    tuples of row-aligned tensors (a row and its precomputed transforms),
    passed to ``fn`` in that order, queries first. The chunk grows to fill
    :func:`block_elems`; one reduction over D per distance either way."""
    qs = q if isinstance(q, tuple) else (q,)
    xs = x if isinstance(x, tuple) else (x,)
    nq, d = qs[0].shape
    n = xs[0].shape[0]
    if n == 0:
        return qs[0].new_zeros((nq, 0))
    chunk = min(max(chunk, block_elems(qs[0].device) // max(nq * d, 1)), n)
    red = torch.sum if reduce == "sum" else torch.amax
    qb = [t[:, None, :] for t in qs]
    outs = [
        red(fn(*qb, *(t[s:s + chunk][None, :, :] for t in xs)), dim=-1) for s in range(0, n, chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def l1_blocked(q, x, chunk: int = 256):
    return elementwise_blocked(lambda a, b: torch.abs(a - b), q, x, "sum", chunk)


def linf_blocked(q, x, chunk: int = 256):
    return elementwise_blocked(lambda a, b: torch.abs(a - b), q, x, "max", chunk)


def lp_blocked(q, x, p: float, chunk: int = 256):
    d = elementwise_blocked(lambda a, b: torch.abs(a - b) ** p, q, x, "sum", chunk)
    return d ** (1.0 / p)


def _safe_log38(v):
    return torch.log(torch.clamp_min(v, 1e-38))


def js_div_blocked(q, x, chunk: int = 128):
    """Jensen-Shannon divergence, blocked elementwise (reference:
    src/distcomp_js.cc). Elementwise: 0.5*[ q log(2q/(q+x)) + x log(2x/(q+x)) ]
    with 0 log 0 := 0, each a * log(a / m) taken as a * (log a - log m)
    with both logs clamped at 1e-38, as tpu_knn takes it. log q and log x
    are taken once per row instead of once per pair: the same values."""

    def fn(a, la, b, lb):
        lm = _safe_log38(0.5 * (a + b))
        ta = torch.where(a > 0, a * (la - lm), 0.0)
        tb = torch.where(b > 0, b * (lb - lm), 0.0)
        return 0.5 * (ta + tb)

    return elementwise_blocked(fn, (q, _safe_log38(q)), (x, _safe_log38(x)), "sum", chunk)
