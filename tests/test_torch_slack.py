"""The certificate's accumulation slack (tpu_knn_torch/methods/seq_search.py
_acc_slack) against a numpy emulation of the tensor cores' accumulation.

Hopper's tensor cores add the exact products of one k16 step and the
running f32 sum after aligning all of them to the largest and truncating
the bits shifted out, then truncate the normalized result (Fasi, Higham,
Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ CS
7:e330, 2021). The emulation does exactly that, with no guard bits (the
worst case), in the order of csrc/groupmin_wgmma.cu: k-steps of 16 in k
order, and within a step hi.hi, hi.lo, lo.hi into one accumulator (hi.hi
alone for bfloat16), the first step overwriting it. On random and
adversarial rows the emulated dot must stay within _acc_slack * |q||x| of
the exact sum of the same bf16 products."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_knn_torch.methods import seq_search as TSS  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402

PAIRS = 256


def _trunc(v, ulp):
    """v truncated toward zero to a multiple of ulp."""
    return np.trunc(v / ulp) * ulp


def _ulp_of(v):
    """2^(floor(log2|v|) - 23), the f32 ulp of |v| (1 where v == 0)."""
    _, ex = np.frexp(np.where(v == 0, 1.0, np.abs(v)))
    return np.ldexp(1.0, ex - 1 - 23)


def _tc_step(acc, prods):
    """One tensor-core k16 step: acc [P] + the 16 exact products [P, 16],
    aligned to the largest addend and truncated, summed exactly, and the
    sum truncated to 24 significant bits."""
    terms = np.concatenate([acc[:, None], prods], axis=1)
    ulp = _ulp_of(np.abs(terms).max(axis=1))
    s = _trunc(terms, ulp[:, None]).sum(axis=1)  # multiples of ulp below 2^29 ulp: exact in f64
    return _trunc(s, _ulp_of(s))


def _emulate(q, x, tier):
    """The kernel's dot of each row pair (q[i], x[i]) and the exact sum of
    the same bf16 products, both f64 [P]."""
    qh, ql = (t.double().numpy() for t in GM._bf16_split(torch.from_numpy(q)))
    xh, xl = (t.double().numpy() for t in GM._bf16_split(torch.from_numpy(x)))
    passes = [(qh, xh)] if tier == "bfloat16" else [(qh, xh), (qh, xl), (ql, xh)]
    d = q.shape[1]
    steps = -(-d // 16)
    pad = steps * 16 - d
    passes = [(np.pad(a, ((0, 0), (0, pad))), np.pad(b, ((0, 0), (0, pad)))) for a, b in passes]
    acc = np.zeros(q.shape[0])
    exact = np.zeros(q.shape[0])
    for j in range(steps):
        for a, b in passes:
            prods = a[:, 16 * j:16 * j + 16] * b[:, 16 * j:16 * j + 16]  # bf16 x bf16: exact in f64
            acc = _tc_step(acc, prods)
            exact += prods.sum(axis=1)
    return acc, exact


def _rows(case, d, seed):
    rng = np.random.default_rng(seed)
    if case == "random":
        q = rng.standard_normal((PAIRS, d))
        x = rng.standard_normal((PAIRS, d))
    elif case == "one_huge":  # one component dwarfs the rest: every other product is shifted out
        q = rng.standard_normal((PAIRS, d))
        x = rng.standard_normal((PAIRS, d))
        q[:, 0] *= 4096.0
        x[:, 0] *= 4096.0
    elif case == "alternating":  # signs alternate along k, so partial sums cancel
        q = np.exp2(rng.uniform(-8, 8, (PAIRS, d)))
        x = np.tile(np.array([1.0, -1.0]), (PAIRS, d // 2)) * np.exp2(rng.uniform(-8, 8, (PAIRS, d)))
    else:  # "wide": magnitudes over 2^-20 .. 2^20
        q = rng.standard_normal((PAIRS, d)) * np.exp2(rng.uniform(-20, 20, (PAIRS, d)))
        x = rng.standard_normal((PAIRS, d)) * np.exp2(rng.uniform(-20, 20, (PAIRS, d)))
    return q.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "one_huge", "alternating", "wide"])
@pytest.mark.parametrize("d", [24, 128, 136, 960])
@pytest.mark.parametrize("tier", ["high", "bfloat16"])
def test_emulated_accumulation_within_acc_slack(tier, d, case):
    q, x = _rows(case, d, seed=d + len(case))
    got, exact = _emulate(q, x, tier)
    norms = np.linalg.norm(q.astype(np.float64), axis=1) * np.linalg.norm(x.astype(np.float64), axis=1)
    ratio = np.abs(got - exact) / (TSS._acc_slack(tier, d) * norms)
    assert ratio.max() <= 1.0, (tier, d, case, ratio.max())
    assert ratio.max() > 0.0  # the emulation does truncate


def test_emulation_truncates_toward_zero():
    """The step model itself: 1 + 2^-24 loses its low bit after alignment
    (truncation, not rounding), and a sum that reaches 2^24 keeps 24 bits."""
    one = np.ones(1)
    prods = np.zeros((1, 16))
    prods[0, 0] = 2.0**-24
    assert _tc_step(one, prods)[0] == 1.0
    prods[0, :2] = [2.0**-23, 2.0**-24]  # 1 + 2^-23 + 2^-24 -> 1 + 2^-23
    assert _tc_step(one, prods)[0] == 1.0 + 2.0**-23
    big = np.full((1, 16), 2.0**20 + 1.0)  # sum 2^24 + 16: exact in 24 bits after the carry
    assert _tc_step(np.zeros(1), big)[0] == 16 * (2.0**20 + 1.0)
