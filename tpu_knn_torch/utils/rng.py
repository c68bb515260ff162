"""Deterministic RNG helpers.

The reference seeds a thread-local mt19937 from defaultRandomSeed
(reference: include/utils.h:75-129, src/init.cc:34-35). Here a
module-level default seed mirrors initLibrary(seed=...) and feeds numpy
generators (host data) and ``torch.Generator``s (device draws). The two
give different numbers from one seed: data that must match tpu_knn is
drawn with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_SEED = 0


def set_default_seed(seed: int) -> None:
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed)


def default_seed() -> int:
    return _DEFAULT_SEED


def np_rng(seed: int | None = None) -> np.random.Generator:
    return np.random.default_rng(_DEFAULT_SEED if seed is None else seed)


def torch_generator(seed: int | None = None, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded like :func:`np_rng`."""
    return torch.Generator(device=device).manual_seed(_DEFAULT_SEED if seed is None else seed)


# ---------------- jax.random.normal without jax ----------------
#
# A saved sketch-proxy index stores only the projection's seed; the
# projection is drawn again on load. For a file to search alike in both
# packages, the port draws tpu_knn's matrix, jax.random.normal(PRNGKey(
# uint32(seed)), shape, float32), from its definition: threefry-2x32 in
# jax's partitionable mode (jax_threefry_partitionable), jax's
# uniform-from-bits map onto [nextafter(-1, 0), 1) and XLA's f32 ErfInv
# polynomial. CUDA torch has few uint32 kernels, so the uint32 words are
# carried in int64 tensors and masked after every add and shift.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al., SC'11), as
    jax's ``threefry2x32_p`` computes it: key (k0, k1), counter words
    (x0, x1) as int64 tensors holding uint32 values. Returns the two output
    words the same way."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits32(seed: int, n: int, device="cpu") -> torch.Tensor:
    """jax.random.bits(PRNGKey(uint32(seed)), (n,), uint32) in partitionable
    mode, as int64: element i is the xor of the two words threefry makes of
    the counter (0, i) under the key (0, seed)."""
    hi = torch.zeros(n, dtype=torch.int64, device=device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(0, int(seed) & _M32, hi, lo)
    return a ^ b


def _uniform_pm1(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's map of 32 random bits onto [lo, 1) with lo =
    nextafter(-1, 0) in f32: 23 mantissa bits under the exponent of 1.0
    give f in [1, 2); then max(lo, (f - 1) * (1 - lo) + lo), where 1 - lo
    rounds to 2.0 in f32."""
    fb = (bits >> 9) | 0x3F800000
    f = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.clamp_min(f * 2.0 + lo, lo)


def _fma(a, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as the fused multiply-adds XLA's CPU
    code contracts its polynomials into: the product is exact in float64
    and the sum is rounded to float64, then to f32 (a second rounding
    that can move a result by one ulp once in about 2^29 ties)."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).float()


#: XLA's log1p(x) for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x), the
#: Cephes rational (xla/service/elemental_ir_emitter.cc EmitLog1p)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: Cephes logf's polynomial on [sqrt(1/2) - 1, sqrt(2) - 1] and its split ln 2
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _log_xla(y: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log on the CPU for positive normal y: Cephes logf with the
    polynomial in three interleaved Horner parts, multiply-adds fused."""
    m, e = torch.frexp(y)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c) for c in _LOG_P]
    a = _fma(p[0], x, p[1])
    b = _fma(p[3], x, p[4])
    c = _fma(p[6], x, p[7])
    a = _fma(a, x, p[2])
    b = _fma(b, x, p[5])
    c = _fma(c, x, p[8])
    a = _fma(a, x3, b)
    a = _fma(a, x3, c)
    a = _fma(a, x3, e * _f32(-2.12194440e-4))
    return ((x - x2 * 0.5) + a) + e * _f32(0.693359375)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p: the Cephes rational below |x| = sqrt(2) - 1, its
    Horner steps fused and its last terms not, else log(1 + x)."""
    def horner(coeffs):
        acc = torch.full_like(x, _f32(coeffs[0]))
        for c in coeffs[1:]:
            acc = _fma(acc, x, _f32(c))
        return acc

    x2 = x * x
    r = horner(_LOG1P_NUM) / horner(_LOG1P_DEN)
    small = x + (-0.5 * x2 + (x * x2) * r)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, _log_xla(1.0 + x))


#: XLA's f32 ErfInv polynomial (xla/hlo/builder/lib/math.cc ErfInv32),
#: Giles, "Approximating the erfinv function", GPU Computing Gems 2011
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv on the CPU, operation for operation: w =
    -log1p(-x^2), a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3
    with fused Horner steps, times x; +-inf at +-1. ``torch.erfinv`` is
    another approximation and differs by up to 2e-5 here."""
    w = -_log1p_xla(-(x * x))
    lt = w < 5.0
    # correctly rounded sqrt (torch's f32 sqrt on the CPU can be an ulp off;
    # float64 then f32 is exact for sqrt)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def jax_normal(seed: int, shape: tuple, device="cpu") -> torch.Tensor:
    """jax.random.normal(jax.random.PRNGKey(uint32(seed)), shape, float32)
    drawn in torch on ``device``: sqrt(2) * erf_inv(uniform on [lo, 1))."""
    n = int(np.prod(shape))
    u = _uniform_pm1(random_bits32(seed, n, device))
    return (np.float32(np.sqrt(2.0)).item() * erfinv_xla(u)).reshape(shape)
