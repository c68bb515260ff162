"""The elementwise spaces' scan (tpu_knn_torch/ops/elementwise.py; on the
card csrc/groupmin_elementwise.cu) on the CPU, where each wrapper runs its
plain version, held against tpu_knn on the same seeded numpy inputs.

Tolerances: rtol 5e-3 / atol 1e-5 (ROADMAP.md's), the f32 sums over D in
torch's order against XLA's; linf is a max and bit-equal. NaN stays NaN
and each infinity stays equal (numpy's assert_allclose and
assert_array_equal compare NaN as equal to NaN). JS runs on non-negative
rows only: XLA's CPU backend flushes subnormals, so where a negative row
drives m below 1e-38 its clamp's log is -inf in tpu_knn and log(1e-38)
in the port (torch keeps the subnormal), as on the card."""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.ops import distance as JD  # noqa: E402
from tpu_knn_torch.core.registry import create_space, known_spaces  # noqa: E402
from tpu_knn_torch.ops import elementwise as EW  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
Q, N, D = 13, 384, 20  # ragged Q, three groups, D not a multiple of 8
PAD_ROWS = 40  # trailing padding rows: zero vectors with a 1e30 pad

#: the thirteen names with an elementwise form, and the form
ELEMENTWISE = {
    "l1": ("l1", None), "dummy": ("l1", None), "linf": ("linf", None), "lp": ("lp", 3.0),
    **{n: ("js", None) for n in ("jsdivslow", "js_div_slow", "jsdivfast", "js_div_fast", "jsdivfastapprox",
                                 "js_div_fast_approx")},
    **{n: ("jsmetr", None) for n in ("jsmetrslow", "jsmetrfast", "jsmetrfastapprox")},
}
#: parameters the registry needs to build a space
SPACE_PARAMS = {"lp": {"p": 3.0}, "abdiv_fast": {"alpha": 1.2, "beta": 0.7}, "abdiv_slow": {"alpha": 1.2, "beta": 0.7},
                "renyidiv_fast": {"alpha": 0.75}, "renyidiv_slow": {"alpha": 0.75}, "word_embed": {"dist": "l2"}}


def _jax_dists(form, q, x, p):
    """tpu_knn's blocked distances [Q, N] of ``form`` (its spaces' blocks)."""
    q, x = jnp.asarray(q), jnp.asarray(x)
    if form == "l1":
        return JD.l1_blocked(q, x)
    if form == "linf":
        return JD.linf_blocked(q, x)
    if form == "lp":
        return JD.lp_blocked(q, x, p)
    d = JD.js_div_blocked(q, x)
    return jnp.sqrt(jnp.maximum(d, 0.0)) if form == "jsmetr" else d


def _inputs(kind, seed, special=True):
    """(q [Q, D], x [N, D], pad [N]): histograms (Dirichlet(0.1), zeros
    reach the clamps) or signed normals, a zero row, a NaN, a +inf and a
    -inf cell (signed rows only: JS takes non-negative rows) in the corpus,
    a +inf cell and a zero row in the queries, and PAD_ROWS padding rows."""
    rng = np.random.default_rng(seed)
    if kind == "hist":
        a = rng.dirichlet(np.full(D, 0.1), Q + N).astype(np.float32)
    else:
        a = (rng.standard_normal((Q + N, D)) * 3).astype(np.float32)
    x, q = a[:N].copy(), a[N:].copy()
    x[-PAD_ROWS:] = 0.0
    pad = np.zeros(N, np.float32)
    pad[-PAD_ROWS:] = 1e30
    if special:
        x[3], x[5, 1], x[6, 2] = 0.0, np.nan, np.inf
        q[1, 0], q[2] = np.inf, 0.0
        if kind != "hist":
            x[7, 0] = -np.inf
    return q, x, pad


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [("l1", None, "normal"), ("linf", None, "normal"), ("lp", 0.5, "normal"), ("lp", 3.0, "normal"),
         ("l1", None, "hist"), ("linf", None, "hist"), ("js", None, "hist"), ("jsmetr", None, "hist")]


@pytest.mark.parametrize("form,p,kind", CASES)
def test_plain_groupmin_matches_tpu_knn_pass1(form, p, kind):
    """The plain group-min epilogue against pass1_jnp's math:
    jnp.min((tpu_knn's block + pad).reshape(Q, N/128, 128), 2), with a
    ragged Q, D not a multiple of 8, padding, zero, NaN and +-inf rows."""
    q, x, pad = _inputs(kind, seed=CASES.index((form, p, kind)))
    got = EW.elementwise_groupmin(form, *_t(q, x, pad), p).numpy()
    want = np.asarray(jnp.min((_jax_dists(form, q, x, p) + pad[None, :]).reshape(Q, N // 128, 128), axis=2))
    assert got.shape == want.shape == (Q, N // 128) and got.dtype == np.float32
    assert np.isnan(got).any() and not np.isnan(got).all()  # the NaN cell reaches its group's mins only
    if form == "linf":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form,p,kind", CASES)
def test_plain_dists_match_tpu_knn_block(form, p, kind):
    """The plain distance epilogue against tpu_knn's block + pad, over a
    ragged slice of the corpus (N not a multiple of 128)."""
    q, x, pad = _inputs(kind, seed=100 + CASES.index((form, p, kind)))
    n = N - 37
    got = EW.elementwise_dists(form, *_t(q, x[:n], pad[:n]), p).numpy()
    want = np.asarray(_jax_dists(form, q, x[:n], p) + pad[None, :n])
    assert got.shape == (Q, n)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if form == "linf":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", ["l1", "js"])
def test_plain_groupmin_chunking_changes_nothing(form):
    """The plain group mins are the same whatever the corpus chunk."""
    q, x, pad = _t(*_inputs("hist", seed=9, special=False))
    whole = EW.elementwise_groupmin_reference(form, q, x, pad)
    one_group = EW.elementwise_groupmin_reference(form, q, x, pad, chunk_bytes=Q * 128 * 4)
    torch.testing.assert_close(one_group, whole, rtol=0, atol=0)


def test_pass1_elementwise_set_on_the_thirteen_names():
    """pass1_elementwise() is set on l1, linf, lp, dummy and the nine JS
    names, and None on every other registered space: the affine ones, renyi,
    abdiv, KL, IS, and the sparse, string, bit and composite spaces."""
    got = {}
    for name in known_spaces():
        space = create_space(name, SPACE_PARAMS.get(name, {}), device="cpu")
        if space.pass1_elementwise() is not None:
            got[name] = space.pass1_elementwise()
        else:
            assert name not in ELEMENTWISE
    assert got == ELEMENTWISE
    assert create_space("l2", {}, device="cpu").pass1_affine() is not None
    for name in ("lp", "l1", "linf"):  # p=2 is affine; p=1 and inf are their own forms
        p = {"l1": 1.0, "linf": float("inf"), "lp": 2.0}[name]
        sp = create_space("lp", {"p": p}, device="cpu")
        assert sp.pass1_elementwise() == (None if p == 2.0 else ELEMENTWISE[name])


@pytest.mark.parametrize("form,bad,match", [
    ("l1", "n", "n % 128"),
    ("lp", "p", "p > 0"),
    ("lp", "p0", "p > 0"),
    ("cosine", None, "unknown form"),
    ("l1", "dtype", "float32"),
    ("l1", "shape", "pad"),
])
def test_contract_raises(form, bad, match):
    """The group-min epilogue needs N % 128 == 0; lp needs p > 0; the
    forms are the five named; every tensor is f32 with matching shapes."""
    q, x, pad = _t(*_inputs("normal", seed=3, special=False))
    p = 3.0 if form == "lp" else None
    if bad == "n":
        x, pad = x[:200], pad[:200]
    elif bad in ("p", "p0"):
        p = None if bad == "p" else 0.0
    elif bad == "dtype":
        q = q.double()
    elif bad == "shape":
        pad = pad[:10]
    with pytest.raises(ValueError, match=match):
        EW.elementwise_groupmin(form, q, x, pad, p)


@pytest.mark.parametrize("epilogue", ["groupmin", "dists"])
@pytest.mark.parametrize("d", [0, 12, 20])
def test_kernel_route_needs_d_multiple_of_8(epilogue, d):
    """The kernel's route takes D a positive multiple of 8 and pads
    nothing itself (that would copy the corpus every batch): it raises
    before it loads the kernel."""
    q, x, pad = torch.zeros(3, d), torch.zeros(128, d), torch.zeros(128)
    with pytest.raises(ValueError, match="multiple of 8"):
        EW._launch(epilogue, "l1", q, x, pad, None)


def test_launch_keys_are_the_shared_counters():
    """Every form's launches of each epilogue (group mins, distances,
    batched) are counted in ops/groupmin.py's ``launches``, one key an
    epilogue and kernel form."""
    assert EW.EPILOGUES == ("groupmin", "dists", "batched")
    keys = {EW.launch_key(e, f) for e in EW.EPILOGUES for f in EW.FORMS}
    assert keys == set(GM.ELEMENTWISE) and set(GM.launches) == set(GM.TIERS) | keys | set(GM.SPARSE_QDENSE)
    assert EW.launch_key("dists", "jsmetr") == "elementwise_dists_js"


def _assert_same_knn(ref, got):
    """Distances within the tolerance; an id that differs ties the
    reference's distance at that slot."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i2.dtype == np.int32
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, c], rtol=RTOL, atol=ATOL), (r, c)


def _index(pkg, name, x, chunk):
    idx = pkg.Index(name, pkg.Params(SPACE_PARAMS.get(name, {})), method="seq_search",
                    **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_dense_batch(x)
    if chunk:
        idx.build_index(pkg.Params(chunkSize=chunk))
    return idx


#: 2,560 rows: one 2,560-row chunk is the single pass; chunkSize=12288
#: pads the corpus to 12,288 rows (9,728 of them padding) and takes two passes
ROUTES = (("single", 0), ("twopass", 12288))


@pytest.mark.parametrize("name", ["l1", "linf", "lp", "dummy", "jsdivfast", "jsmetrfast"])
def test_seq_search_knn_and_range_match_tpu_knn(name):
    """Index(name, method="seq_search", device="cpu") on both routes: kNN
    and range against tpu_knn's on 2,560 histograms; ids equal except on
    ties, range hit sets equal except within the tolerance of the radius."""
    x = np.random.default_rng(21).dirichlet(np.full(24, 0.1), 2560).astype(np.float32)
    q = np.random.default_rng(22).dirichlet(np.full(24, 0.1), 16).astype(np.float32)
    for route, chunk in ROUTES:
        j, t = _index(tpu_knn, name, x, chunk), _index(tpu_knn_torch, name, x, chunk)
        ref, got = j.knn_query_batch(q, 10), t.knn_query_batch(q, 10)
        assert t.method.last_route == route
        _assert_same_knn(ref, got)
        radius = float(np.median(ref[0][:, -1]))
        for rj, rt in zip(j.range_query_batch(q, radius), t.range_query_batch(q, radius)):
            assert np.all(np.diff(rt.dists) >= 0) and rt.ids.dtype == np.int32
            mj, mt = dict(zip(rj.ids, rj.dists)), dict(zip(rt.ids, rt.dists))
            for i in set(mj) ^ set(mt):
                assert abs(mj.get(i, mt.get(i)) - radius) <= RTOL * radius + ATOL
            for i in set(mj) & set(mt):
                np.testing.assert_allclose(mt[i], mj[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,want", [("l1", ("l1", None)), ("lp", ("lp", 3.0)), ("jsmetrfast", ("jsmetr", None)),
                                       ("renyidiv_fast", None)])
def test_scan_routes_through_the_wrappers(monkeypatch, name, want):
    """Pass 1 calls elementwise_groupmin once over the whole padded corpus;
    the single pass and both range passes call elementwise_dists once a
    chunk; a space with no elementwise form (renyi) calls neither."""
    calls = []
    for fn in ("elementwise_groupmin", "elementwise_dists"):
        real = getattr(EW, fn)

        def spy(form, q, x, pad, p=None, _fn=fn, _real=real):
            calls.append((_fn, form, p, x.shape[0]))
            return _real(form, q, x, pad, p)

        monkeypatch.setattr(EW, fn, spy)
    x = np.random.default_rng(23).dirichlet(np.full(16, 0.1), 2560).astype(np.float32)
    q = x[:8] + 0.001
    t = _index(tpu_knn_torch, name, x, 12288)
    t.knn_query_batch(q, 10)
    assert t.method.last_route == "twopass"
    pass1 = [c for c in calls if c[0] == "elementwise_groupmin"]
    assert pass1 == ([("elementwise_groupmin", *want, 12288)] if want else [])
    calls.clear()
    s = _index(tpu_knn_torch, name, x, 1024)  # 2,560 rows in three 1,024-row chunks
    s.knn_query_batch(q, 10)
    assert s.method.last_route == "single"
    s.range_query_batch(q, 0.5)
    assert calls == ([("elementwise_dists", *want, 1024)] * 9 if want else [])


# ---- the kernel's per-pair arithmetic (csrc/groupmin_elementwise.cu), modelled in f32 torch ops
# with torch.log2 / torch.exp2 standing in for the card's MUFU lg2 / ex2 ----

JS_TINY2 = np.float32(2) * np.float32(1e-38)  # 2e-38, normal: the clamp of lg2(a + b)
HALF_MAX = np.float32(np.finfo(np.float32).max / 2)  # past it 2a overflows
JS_POST = np.float32(2 * np.log(2.0))  # 4 * 0.5 ln 2: the sums are in quarter log2 units


def _ipow(t, n):
    """t^n by squaring, the kernel's product chain: (t^(n/2))^2 or t^(n-1) t."""
    if n == 1:
        return t
    if n % 2 == 0:
        h = _ipow(t, n // 2)
        return h * h
    return _ipow(t, n - 1) * t


def _model_lp(q, x, p):
    """LP as the kernel takes it: a product chain at a p of LP_POWERS, else ex2(p lg2 t); the sum,
    then s^(1/p)."""
    t = (q[:, None, :] - x[None, :, :]).abs()
    power = EW.lp_power(p)
    terms = _ipow(t, power) if power else torch.exp2(p * torch.log2(t))
    return terms.sum(-1) ** (1.0 / p)


def _js_lg2(s):
    return torch.log2(torch.clamp_min(s, float(JS_TINY2)))  # clamp_min keeps NaN, as max.NaN does


def _js_row_lg2(v):
    """The staged log of an element, a quarter of lg2 of 2 max(v, 1e-38) as the pair log takes
    a + a; of lg2(v) + 1 past FLT_MAX / 2."""
    return 0.25 * torch.where(v > float(HALF_MAX), torch.log2(v) + 1.0, _js_lg2(2.0 * v))


def _model_js(q, x, metric: bool):
    """JS as the kernel takes it (every epilogue): one lg2 a pair, a (La/4 - L/4) + b (Lb/4 - L/4)
    where both values are non-negative (each bracket one FFMA, L/4 exact: one rounding as here),
    the plain version's selects (v > 0 ? v (Lv/4 - L/4) : 0) where one is negative or NaN (the
    group-min and distance epilogues decide per staged tile, the batched one always selects; on a
    pair of non-negative values both forms give the same term), then 2 ln 2 and, for the metric,
    sqrt(max(., 0))."""
    a, b = q[:, None, :], x[None, :, :]
    la, lb = _js_row_lg2(q)[:, None, :], _js_row_lg2(x)[None, :, :]
    lm = 0.25 * _js_lg2(a + b)
    fast = a * (la - lm) + b * (lb - lm)
    guarded = torch.where(a > 0, a * (la - lm), 0.0) + torch.where(b > 0, b * (lb - lm), 0.0)
    d = torch.where((a >= 0) & (b >= 0), fast, guarded).sum(-1) * float(JS_POST)
    return torch.sqrt(torch.clamp_min(d, 0.0)) if metric else d


def _model(form, q, x, p):
    return _model_lp(q, x, p) if form == "lp" else _model_js(q, x, form == "jsmetr")


def _assert_same(got, want):
    """NaN for NaN, equal infinities, the finite cells within rtol 5e-3 / atol 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


MODEL_CASES = [("lp", p, kind) for p in (3.0, 4.0, 5.0, 0.7, 2.5) for kind in ("normal", "hist")] + [
    (form, None, kind) for form in ("js", "jsmetr") for kind in ("hist", "normal", "huge")]


def _model_inputs(kind, seed):
    """The edge sweep's inputs (zero rows, NaN, +-inf cells); "huge": histograms with a cell past
    FLT_MAX / 2 in a query and in a corpus row and one below it in another, in one column, so
    that the query's a + b overflows against both (test_js_two_huge_cells_stay_finite puts two
    huge cells in one pair)."""
    q, x, _ = _inputs("hist" if kind == "huge" else kind, seed)
    if kind == "huge":
        q[4, 3], x[8, 3], x[9, 3] = 2e38, 3e38, 1.5e38
    return q, x


@pytest.mark.parametrize("form,p,kind", MODEL_CASES)
def test_kernel_arithmetic_model_matches_plain(form, p, kind):
    """The kernel's per-pair arithmetic, modelled in f32, against the plain distances
    (ops/elementwise.distances): product chains at p 3, 4, 5; ex2(p lg2 t) at p 0.7 and 2.5; JS
    in log2 units with the 2e-38 clamp, the staged lg2(2a) and the guard for negative and NaN
    values; on histograms and signed normals with zero rows, NaN and +-inf cells (and, for JS,
    values past FLT_MAX / 2 and an a + b that overflows)."""
    q, x = _t(*_model_inputs(kind, seed=MODEL_CASES.index((form, p, kind))))
    want = EW.distances(form, q, x, p)
    got = _model(form, q, x, p)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_same(got, want)
    if kind == "huge" and form == "js":  # the overflowing pairs: -inf in both
        assert got[4, 8] == want[4, 8] == got[4, 9] == want[4, 9] == -np.inf


@pytest.mark.parametrize("form,p", [("lp", 3.0), ("lp", 4.0), ("lp", 5.0), ("lp", 0.7), ("lp", 2.5),
                                    ("js", None), ("jsmetr", None)])
def test_kernel_arithmetic_model_matches_tpu_knn(form, p):
    """The same model against tpu_knn's lp_blocked / js_div_blocked on non-negative rows (XLA's CPU
    flushes subnormals: signed rows drive its JS clamp to -inf) with zero rows, NaN and +inf."""
    q, x, _ = _inputs("hist", seed=40)
    _assert_same(_model(form, *_t(q, x), p), _jax_dists(form, q, x, p))


@pytest.mark.parametrize("form", ["js", "jsmetr"])
def test_js_self_pairs_are_exactly_zero(form):
    """A row against itself: La - L is 0 exactly, so the modelled kernel's JS and JS metric are
    0.0 wherever the plain version's are (every diagonal cell but the +inf row's, NaN in both)."""
    _, x, _ = _inputs("hist", seed=41)
    xt = torch.from_numpy(x[:64])
    got, want = _model(form, xt, xt, None), EW.distances(form, xt, xt)
    zero = want == 0
    assert int(zero.diagonal().sum()) == 63 and bool(torch.isnan(want[6, 6]))
    assert bool((got[zero] == 0).all())
    _assert_same(got, want)


@pytest.mark.parametrize("p,want", [(3.0, 3), (4, 4), (8.0, 8), (0.7, 0), (2.5, 0), (9.0, 0), (2.0, 0)])
def test_lp_power_routes(p, want):
    """lp takes a product chain at a p of LP_POWERS (3-8), the MUFU route at any other p; the
    source instantiates exactly those powers."""
    assert EW.lp_power(p) == want
    assert EW.instance("lp", p) == (f"lp{want}" if want else "lp") and EW.instance("jsmetr") == "js"
    src = (Path(EW.__file__).parent.parent / "csrc" / "groupmin_elementwise.cu").read_text()
    powers = re.search(r"#define TK_LP_POWERS\(X\) (.*)", src).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", powers)) == EW.LP_POWERS


@pytest.mark.parametrize("epilogue", ["groupmin", "dists"])
@pytest.mark.parametrize("form,p,power", [("lp", 3.0, 3), ("lp", 4.0, 4), ("lp", 0.7, 0), ("lp", 2.5, 0),
                                          ("js", None, 0), ("jsmetr", None, 0)])
def test_launch_passes_route_and_parameters(monkeypatch, epilogue, form, p, power):
    """What _launch hands the library (a spy in place of ``_lib``): the kernel form, LP's power
    (3 and 4 their product chains, 0.7 and 2.5 the MUFU route), the epilogue, the shapes, p and
    1/p, the sqrt post, the stream; and one count on the epilogue's and form's launch key."""
    calls = []

    class Spy:
        def tk_elementwise(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(EW, "_lib", Spy)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(GM, "launches", dict.fromkeys(GM.launches, 0))
    q, x, pad = torch.zeros(5, 16), torch.zeros(256, 16), torch.zeros(256)
    out = EW._launch(epilogue, form, q, x, pad, p)
    assert out.shape == ((5, 2) if epilogue == "groupmin" else (5, 256))
    (args,) = calls
    kform, got_power, groupmin, qp, xp, pp, op, nq, n, d, pf, inv_p, sqrt_post, stream = args
    assert (kform, got_power, groupmin) == (EW.FORMS[form][0], power, int(epilogue == "groupmin"))
    assert (qp, xp, pp, op) == (q.data_ptr(), x.data_ptr(), pad.data_ptr(), out.data_ptr())
    assert (nq, n, d, sqrt_post, stream) == (5, 256, 16, int(form == "jsmetr"), 77)
    assert (pf, inv_p) == ((p, 1.0 / p) if form == "lp" else (0.0, 0.0))
    assert GM.launches == {k: int(k == EW.launch_key(epilogue, form)) for k in GM.launches}


def test_bound_follows_p():
    """chip_smoke's least work an element pair: lp at an integer p a product chain (p=3: a
    subtraction, a product and the FFMA into the sum, no MUFU), at any other p two MUFU; its
    bounds at 2048 x 65,536 x 128 and at the 1M jsdivfast cell's pass 1."""
    import chip_smoke as CS

    assert [CS._ew_min_ops("lp", p) for p in (3.0, 4.0, 5.0, 7.0, 0.7, 2.5)] == [
        (3, 0), (3, 0), (4, 0), (5, 0), (3, 2), (3, 2)]
    assert CS._ew_min_ops("js") == (3, 1) and CS._ew_min_ops("l1") == (2, 0)
    for form, p, shape, want in (("lp", 3.0, (2048, 65536), 1.539), ("lp", 0.7, (2048, 65536), 8.205),
                                 ("js", None, (2048, 65536), 4.103), ("js", None, (256, 1_007_616), 7.885),
                                 ("l1", None, (2048, 65536), 1.026)):
        ms, by = CS._ew_bound_ms(form, *shape, 128, "groupmin", p)
        assert by == "operations" and ms == pytest.approx(want, abs=1e-3), (form, p, ms)


@pytest.mark.parametrize("mangled,key", [
    ("_ZN12_GLOBAL__N_127groupmin_elementwise_kernelILi0ELb1EEEvPKfS2_S2_Pfllifffil", ("0", None, "1")),
    ("_ZN12_GLOBAL__N_127groupmin_elementwise_kernelILi2ELi3ELb0EEEvPKfS2_S2_Pfllifffil", ("2", "3", "0")),
])
def test_turns_tool_matches_both_template_signatures(mangled, key):
    """tools/elementwise_turns.py pairs the instances of two builds by form, LP power and epilogue,
    with or without the LP power among the template arguments."""
    from tpu_knn_torch.tools import elementwise_turns as T

    assert T._KERNEL.search(mangled).groups() == key
