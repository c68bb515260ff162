"""The batched epilogue's pair form (Cq > 1; csrc/groupmin_elementwise.cu ``elementwise_pair_kernel``)
on the CPU: an f32 model of the kernel's order (each (query, row) summed in sequence over k with the
kernel's per-pair arithmetic) held against the plain version and tpu_knn's vmapped blocks; the tiling
that csrc/pair_tiling.h picks for the kernel (built here by the host compiler); and the heuristic's
pair scorer reaching the wrapper once a call.

Tolerances: rtol 5e-3 / atol 1e-5 (ROADMAP.md's), the f32 sums in the kernel's order against torch's
and XLA's; linf is a max and bit-equal. NaN stays NaN and each infinity stays equal."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn_torch  # noqa: E402
from test_torch_elementwise import (ELEMENTWISE, HALF_MAX, JS_POST, JS_TINY2, SPACE_PARAMS,  # noqa: E402
                                    _assert_same, _ipow)
from test_torch_elementwise_gathered import _jax_batched  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.ops import elementwise as EW  # noqa: E402

B, D = 3, 20  # D not a multiple of 8: the model sums the zero columns the spaces append, as the kernel does

# ---- the kernel's order, modelled in f32 torch ops (torch.log2 / torch.exp2 for the MUFU's lg2 / ex2) ----


def _fma(x, y, z):
    """fmaf in f32: the product exact in f64, one rounding of the sum (to f64, then f32)."""
    return (x.double() * y.double() + z.double()).float()


def _js_lg2(s):
    return torch.log2(torch.clamp_min(s, float(JS_TINY2)))  # clamp_min keeps NaN, as max.NaN does


def _js_row_lg2(v):
    return 0.25 * torch.where(v > float(HALF_MAX), torch.log2(v) + 1.0, _js_lg2(2.0 * v))


def _pair_term(form, acc, a, b, p, signed):
    """One k step of every (query, row) pair: ``acc`` [B, Cq, K] after accumulate<F, P, SIGNED> of
    a [B, Cq, 1] and b [B, 1, K]. JS's SIGNED (the guarded pair) is the kernel's per-stage choice
    where a staged value is negative or NaN; on a pair of non-negative values both give the same
    term, so the model takes it where either value is."""
    if form == "l1":
        return acc + (a - b).abs()
    if form == "linf":
        return torch.maximum(acc, (a - b).abs())  # NaN-carrying, as max.NaN
    if form == "lp":
        t = (a - b).abs()
        power = EW.lp_power(p)
        if power % 2 == 0 and power:
            h = _ipow(t, power // 2)
            return _fma(h, h, acc)
        if power:
            return _fma(_ipow(t, power - 1), t, acc)
        return acc + torch.exp2(p * torch.log2(t))
    la, lb = _js_row_lg2(a), _js_row_lg2(b)
    lm = _js_lg2(a + b)
    da, db = la + lm * -0.25, lb + lm * -0.25  # js_diff: one FFMA, l / 4 exact
    fast = _fma(b.expand_as(acc), db, _fma(a.expand_as(acc), da, acc))
    guarded = acc + (torch.where(a > 0, a * da, 0.0) + torch.where(b > 0, b * db, 0.0))
    return torch.where(signed, guarded, fast)


def _model_pairs(form, q, rows, pad, p=None):
    """out[b, i, j] as the pair kernel sums it: acc = 0, then each column k in order (the zero
    columns up to a multiple of 8 included), post<F>, + pad."""
    kform = EW.kernel_form(form)
    dz = -q.shape[2] % EW.D_MULTIPLE
    q, rows = (torch.nn.functional.pad(t, (0, dz)) for t in (q, rows))
    acc = torch.zeros(q.shape[0], q.shape[1], rows.shape[1])
    for k in range(q.shape[2]):
        a, b = q[:, :, k, None], rows[:, None, :, k]
        signed = ~((a >= 0) & (b >= 0))
        acc = _pair_term(kform, acc, a, b, p, signed)
    if kform == "lp":
        acc = acc ** float(np.float32(1.0 / p))
    elif kform == "js":
        acc = acc * float(JS_POST)
        if form == "jsmetr":
            acc = torch.sqrt(torch.clamp_min(acc, 0.0))
    return acc + pad[:, None, :]


def _pair_inputs(kind, c, seed):
    """(q [B, C, D], rows [B, C, D], pad [B, C]): signed normals or histograms (Dirichlet(0.1)); in
    the rows a zero row, a NaN, a +inf cell and (signed rows only: JS takes non-negative rows against
    tpu_knn) a -inf cell, in the queries a +inf cell and a zero row; 1e30 pads on the last rows of one
    batch item (the padding rows of a gathered candidate set, zero vectors) and +inf on another's;
    histogram components below 1e-30 are 0."""
    rng = np.random.default_rng(seed)
    n = 2 * B * c
    a = (rng.dirichlet(np.full(D, 0.1), n) if kind == "hist" else rng.standard_normal((n, D)) * 3).astype(np.float32)
    if kind == "hist":  # no subnormal components: XLA's CPU flushes them to 0
        a[a < 1e-30] = 0.0
    q, rows = a[:B * c].reshape(B, c, D).copy(), a[B * c:].reshape(B, c, D).copy()
    last = c - 1
    rows[0, last], rows[1, last, 1], rows[2, last // 2, 2] = 0.0, np.nan, np.inf
    if kind != "hist":
        rows[2, 0, 0] = -np.inf
    q[1, last, 0], q[2, 0] = np.inf, 0.0
    pad = np.zeros((B, c), np.float32)
    npad = max(1, c // 8)
    rows[0, c - npad:] = 0.0
    pad[0, c - npad:], pad[2, -1] = 1e30, np.inf
    return q, rows, pad


PAIR_FORMS = [("l1", None, "normal"), ("linf", None, "normal"), ("lp", 3.0, "normal"), ("lp", 0.7, "normal"),
              ("js", None, "hist"), ("jsmetr", None, "hist")]


@pytest.mark.parametrize("c", [2, 24, 40, 108, 129])
@pytest.mark.parametrize("form,p,kind", PAIR_FORMS)
def test_pair_model_matches_plain_and_tpu_knn(form, p, kind, c):
    """The pair kernel's order (each pair summed over k in sequence, the kernel's per-pair
    arithmetic: LP's product chain or ex2(p lg2 t), JS in quarter log2 units with the guard) against
    elementwise_batched's plain version and tpu_knn's jax.vmap of its blocks, at Cq = K = c (the
    build's reverse shrink 24 and 40, its forward heuristic 108, one past a 128-pair tile), with
    zero, NaN and +-inf cells, 1e30 padding rows and a +inf pad."""
    q, rows, pad = _pair_inputs(kind, c, seed=PAIR_FORMS.index((form, p, kind)) * 10 + c)
    qt, rt, pt = (torch.from_numpy(v) for v in (q, rows, pad))
    got = _model_pairs(form, qt, rt, pt, p).numpy()
    plain = EW.elementwise_batched(form, qt, rt, pt, p).numpy()
    jaxv = _jax_batched(form, q, rows, p) + pad[:, None, :]
    assert got.shape == plain.shape == (B, c, c) and got.dtype == np.float32
    assert np.isnan(plain).any() and np.isinf(plain).any()
    for want in (plain, jaxv):
        if form == "linf":
            np.testing.assert_array_equal(got, want)
        else:
            _assert_same(got, want)


def test_pair_model_js_two_huge_cells_stay_finite():
    """The two-2e38-cell JS pair (one cell on each side) in the pair kernel's order: tpu_knn's
    1.3863068e+38, finite, for both queries of a Cq = 2 item."""
    q, x = torch.zeros(1, 2, 16), torch.zeros(1, 3, 16)
    q[0, :, 0], x[0, :, 1] = 2e38, 2e38
    got = _model_pairs("js", q, x, torch.zeros(1, 3)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.full((1, 2, 3), 1.3863068e38), rtol=5e-3)


# ---- chip_smoke's float64 check of jsmetr cells beyond rtol 5e-3 of the plain version ----


def _near_zero_js_items():
    """q, rows [3, 108, 8] of the batched sweep's tiny kind (values in [1e-39, 4e-38), zeros and
    signed normals), each item's first 24 rows a copy of its query with one positive cell off by
    1%: a JS near 0 (about 1e-5 to 1e-4) in those (i, i) cells, the mask of which comes third."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((2 * 3 * 108, 8)) * 4
    r = rng.random(a.shape)
    a = np.where(r < 0.4, rng.uniform(1e-39, 4e-38, a.shape), np.where(r < 0.6, 0.0, a)).astype(np.float32)
    q, rows = a[:324].reshape(3, 108, 8).copy(), a[324:].reshape(3, 108, 8).copy()
    q[:, :24, 0] = np.abs(q[:, :24, 0]) + 1.0
    rows[:, :24] = q[:, :24]
    rows[:, :24, 0] *= np.float32(1.01)
    near = torch.zeros(3, 108, 108, dtype=torch.bool)
    near[:, torch.arange(24), torch.arange(24)] = True
    return torch.from_numpy(q), torch.from_numpy(rows), near


def test_jsmetr_float64_check_holds_the_model_and_catches_planted_faults():
    """chip_smoke._jsmetr_f64_ok holds the f32 model of the pair kernel's order within the f32
    bound of the float64 JS at every cell, and rejects planted faults: a column of D dropped (at
    every cell, and at the near-zero cells alone), the near-zero cells 3x too large, a nonzero pad;
    _ew_compare with the check on still fails the dropped column against the plain version."""
    import chip_smoke as CS

    q, rows, near = _near_zero_js_items()
    pad = torch.zeros(3, 108)
    got = _model_pairs("jsmetr", q, rows, pad)
    every = torch.isfinite(got)
    assert bool(every.all())
    ok, worst = CS._jsmetr_f64_ok(got, every, q, rows, pad)
    assert ok and worst["ratio"] <= 1.0
    js, _ = CS._js_f64(q[:, :24].double().reshape(-1, 8), rows[:, :24].double().reshape(-1, 8))
    assert bool((js > 1e-6).all() and (js < 1e-3).all())  # near 0, where the sqrt amplifies
    dropped = _model_pairs("jsmetr", q[:, :, 1:].contiguous(), rows[:, :, 1:].contiguous(), pad)
    assert not CS._jsmetr_f64_ok(dropped, every, q, rows, pad)[0]
    assert not CS._jsmetr_f64_ok(dropped, near, q, rows, pad)[0]
    assert not CS._jsmetr_f64_ok(got * 3, near, q, rows, pad)[0]
    padded = pad.clone()
    padded[0, 0] = 1e30
    assert not CS._jsmetr_f64_ok(got, near, q, rows, padded)[0]
    ref = EW.elementwise_batched_reference("jsmetr", q, rows, pad)
    CS._ew_compare("model", got, ref, False, (q, rows, pad))
    with pytest.raises(RuntimeError, match="within rtol"):
        CS._ew_compare("planted", dropped, ref, False, (q, rows, pad))


# ---- the tiling csrc/pair_tiling.h picks for the pair kernel ----

#: a host-compiled entry to the header: the tiling, as the library's geometry entry writes it, and
#: the limits it keeps to
_SHIM = """#include "pair_tiling.h"
extern "C" void tiling(int cq, long long k, int logs, int* out) { put_pair_tiling(pair_tiling(cq, k, logs), out); }
extern "C" void limits(int* out) { out[0] = PAIR_LOADS, out[1] = PAIR_THREADS, out[2] = PAIR_SMEM; }
"""


@pytest.fixture(scope="module")
def pair_tiling(tmp_path_factory):
    """(cq, k, form) -> csrc/pair_tiling.h's tiling as ops/elementwise.py geometry_dict reports it,
    and the header's (LOADS, PAIR_THREADS, PAIR_SMEM)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ here")
    out = tmp_path_factory.mktemp("pair_tiling")
    (out / "shim.cpp").write_text(_SHIM)
    csrc = Path(EW.__file__).resolve().parent.parent / "csrc"
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC", "-I", str(csrc), "-o",
                    str(out / "shim.so"), str(out / "shim.cpp")], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out / "shim.so"))
    lib.tiling.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lim = (ctypes.c_int * 3)()
    lib.limits(lim)

    def tiling(cq, k, form):
        ints = (ctypes.c_int * len(EW.PAIR_GEOMETRY))()
        lib.tiling(cq, k, int(EW.kernel_form(form) == "js"), ints)
        return EW.geometry_dict(cq, k, ints)

    return tiling, tuple(lim)


def _invariants(geo, cq, k, form, limits):
    """What the pair kernel needs of its tiling."""
    loads, max_threads, max_smem = limits
    tq, tr, bk = geo["tq"], geo["tr"], geo["bk"]
    assert geo["ny"] >= 1 and geo["nx"] >= 1 and geo["g"] >= 1
    assert geo["qt"] * geo["ny"] * tq >= cq and geo["rt"] * geo["nx"] * tr >= k  # every pair covered
    assert (geo["qt"] - 1) * geo["ny"] * tq < cq and (geo["rt"] - 1) * geo["nx"] * tr < k  # no empty tile
    assert geo["threads"] % 32 == 0 and geo["g"] * geo["ny"] * geo["nx"] <= geo["threads"] <= max_threads
    vecs = geo["g"] * (geo["ny"] * tq + geo["nx"] * tr)
    assert vecs * (bk // 4) <= loads * geo["threads"]
    logs = EW.kernel_form(form) == "js"
    assert geo["smem"] == (4 if logs else 2) * vecs // 4 * (bk + 1) * 16 <= max_smem


@pytest.mark.parametrize("form", ["l1", "linf", "lp", "js"])
@pytest.mark.parametrize("cq,k", [(2, 2), (5, 1), (5, 300), (24, 24), (40, 40), (40, 300), (100, 100), (108, 108),
                                  (129, 129), (136, 72), (208, 208), (3, 5000)])
def test_batched_geometry_is_a_tiling_the_kernel_runs(pair_tiling, cq, k, form):
    """At every (Cq, K) the tiling covers every pair with no empty tile, fits a block's threads,
    loads (at most LOADS 16-byte loads a thread a stage) and shared memory (JS's logs take as much
    again)."""
    tiling, limits = pair_tiling
    geo = tiling(cq, k, form)
    assert geo["kernel"] == "pairs" and 0 < geo["real"] <= 1
    _invariants(geo, cq, k, form, limits)


@pytest.mark.parametrize("form", ["l1", "js"])
def test_batched_geometry_keeps_the_build_shapes_real(pair_tiling, form):
    """At the build's Cq = K = 24, 40 (the reverse shrink, bound by their bytes) and 100, 108 (the
    forward heuristic, bound by their work), at least 75% of the pairs the block's warps compute
    are real; 24 and 40 take one block tile an item (no vector read twice) with several items a
    block, 108 splits over blocks to waste less; a C of 208 tiles over blocks."""
    tiling, _ = pair_tiling
    for c in (24, 40, 100, 108):
        assert tiling(c, c, form)["real"] >= 0.75, c
    for c in (24, 40):
        geo = tiling(c, c, form)
        assert (geo["qt"], geo["rt"]) == (1, 1) and geo["g"] >= 2, geo
    geo = tiling(108, 108, form)
    assert geo["real"] >= 0.9 and geo["qt"] * geo["rt"] > 1
    geo = tiling(208, 208, form)
    assert geo["qt"] * geo["rt"] > 1 and geo["real"] >= 0.75
    with pytest.raises(ValueError):
        EW.batched_geometry(0, 5)


@pytest.mark.parametrize("form", ["l1", "js"])
def test_pair_tiling_picks_the_tilings_timed_on_the_card(pair_tiling, form):
    """(ny, nx, g, qt, rt) at the shapes PERF.md section 6 times: 6 x 6 threads and 5 items a block
    at 24, 10 x 10 and 2 items at 40, 25 x 5 threads, 2 items and 5 block tiles at 100, 27 x 9
    threads and 3 block tiles at 108; and Cq = 1 is the gathered kernel's."""
    tiling, _ = pair_tiling
    want = {24: (6, 6, 5, 1, 1), 40: (10, 10, 2, 1, 1), 100: (25, 5, 2, 1, 5), 108: (27, 9, 1, 1, 3)}
    for c, t in want.items():
        geo = tiling(c, c, form)
        assert tuple(geo[key] for key in ("ny", "nx", "g", "qt", "rt")) == t, (c, geo)
    assert EW.geometry_dict(1, 1536, [4, 32, 128]) == {"kernel": "gathered", "rows_a_warp": 4, "rows_a_block": 32,
                                                        "columns_a_step": 128}


# ---- the heuristic's pair scorer ----


@pytest.mark.parametrize("name", ["l1", "dummy", "linf", "lp", "jsdivfast", "jsmetrfast"])
def test_score_pairs_reaches_the_batched_wrapper_once(monkeypatch, name):
    """hnsw._score_pairs of an elementwise space (the heuristic's cand_i against itself) calls
    elementwise_batched once, with Cq = K = C and the name's form; its distances are the plain
    version's, +inf on the -1 candidates' rows and columns as the padding gives them."""
    form, p = ELEMENTWISE[name]
    calls = []
    real = EW.elementwise_batched

    def spy(f, q, rows, pad, pp=None):
        calls.append((f, pp, tuple(q.shape), tuple(rows.shape)))
        return real(f, q, rows, pad, pp)

    monkeypatch.setattr(EW, "elementwise_batched", spy)
    x = np.random.default_rng(5).dirichlet(np.full(16, 0.1), 300).astype(np.float32)
    idx = tpu_knn_torch.Index(name, tpu_knn_torch.Params(SPACE_PARAMS.get(name, {})), method="seq_search",
                              device="cpu")
    idx.add_dense_batch(x)
    idx.build_index()
    space, data = idx.space, idx.method.data
    qenc = space.encode_queries(x)
    cand = torch.from_numpy(np.random.default_rng(6).integers(-1, 300, (6, 11)).astype(np.int32))
    calls.clear()
    got = TH._score_pairs(space, qenc, 300, space.corpus_dict(data), cand, cand)
    ((f, pp, qs, rs),) = calls
    assert (f, pp) == (form, p) and qs[:2] == rs[:2] == (6, 11) and qs[2] == rs[2]
    assert got.shape == (6, 11, 11)
    ok = cand >= 0
    assert bool(torch.isinf(got[~ok]).all()) and bool(torch.isinf(got.transpose(1, 2)[~ok]).all())
    c = cand.clamp(0).long()
    qv = data.vecs[c].contiguous()
    want = EW.elementwise_batched_reference(form, space.encode_queries(x)["q"][c].contiguous(), qv,
                                            torch.zeros(6, 11), p)
    both = ok[:, :, None] & ok[:, None, :]
    torch.testing.assert_close(got[both], want[both], rtol=5e-3, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("mangled,key", [
    ("_ZN12_GLOBAL__N_126elementwise_batched_kernelILi0ELi0ELi1EEEvPKfS2_S2_Pfilifffil", (0, 0, "gathered")),
    ("_ZN12_GLOBAL__N_126elementwise_batched_kernelILi3ELi0ELi32EEEvPKfS2_S2_Pfilifffil", (3, 0, "pairs QG 32")),
    ("_ZN12_GLOBAL__N_123elementwise_pair_kernelILi2ELi3EEEvPKfS2_S2_Pflilifffi10PairTiling", (2, 3, "pairs")),
    ("_ZN12_GLOBAL__N_127groupmin_elementwise_kernelILi1ELi0ELb0EEEvPKfS2_S2_Pfllifffil", (1, 0, "dists")),
])
def test_turns_tool_keys_the_batched_kernels(mangled, key):
    """tools/elementwise_turns.py --sass pairs the Cq = 1 kernel of two builds, and keys the pair
    kernel apart from the reduce-scatter kernel it replaced."""
    from tpu_knn_torch.tools import elementwise_turns as T

    assert T._sass_key(mangled) == key
