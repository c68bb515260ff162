"""The batched epilogue of the elementwise kernel (tpu_knn_torch/ops/elementwise.py
``elementwise_batched``; on the card csrc/groupmin_elementwise.cu) on the CPU, where it runs its
plain version, held against tpu_knn's vmapped blocks; the routes by which the thirteen
elementwise names reach the kernel's wrappers; and the JS arithmetic at the edges of f32.

Tolerances: rtol 5e-3 / atol 1e-5 (ROADMAP.md's); linf is a max and bit-equal. NaN stays NaN and
each infinity stays equal."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_knn_torch  # noqa: E402
from test_torch_elementwise import ELEMENTWISE, SPACE_PARAMS, _assert_same, _jax_dists, _model_js  # noqa: E402
from tpu_knn.ops import distance as JD  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.ops import elementwise as EW  # noqa: E402
from tpu_knn_torch.ops import graph as G  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
B, K, D = 4, 37, 20  # ragged K, D not a multiple of 8 (the plain version takes any D)


def _batched_inputs(kind, cq, seed):
    """(q [B, Cq, D], rows [B, K, D], pad [B, K]): histograms (Dirichlet(0.1)) or signed normals;
    in the rows a zero row, a NaN, a +inf cell and (signed rows only: JS takes non-negative rows
    against tpu_knn) a -inf cell, in the queries a +inf cell and a zero row where Cq > 2; +inf pads
    on the last rows of one batch item and 1e30 on another's."""
    rng = np.random.default_rng(seed)
    n = B * (cq + K)
    a = (rng.dirichlet(np.full(D, 0.1), n) if kind == "hist" else rng.standard_normal((n, D)) * 3).astype(np.float32)
    q, rows = a[:B * cq].reshape(B, cq, D).copy(), a[B * cq:].reshape(B, K, D).copy()
    rows[0, 3], rows[1, 5, 1], rows[2, 6, 2] = 0.0, np.nan, np.inf
    if kind != "hist":
        rows[3, 7, 0] = -np.inf
    if cq > 2:
        q[1, 1, 0], q[2, 2] = np.inf, 0.0
    pad = np.zeros((B, K), np.float32)
    pad[1, -4:], pad[3, -2:] = np.inf, 1e30
    return q, rows, pad


def _jax_batched(form, q, rows, p):
    """tpu_knn's blocks of each batch item's queries against its own rows (jax.vmap)."""
    return np.asarray(jax.vmap(lambda qq, xx: _jax_dists(form, qq, xx, p))(jnp.asarray(q), jnp.asarray(rows)))


BATCHED = [("l1", None, "normal"), ("linf", None, "normal"), ("lp", 3.0, "normal"), ("lp", 0.7, "normal"),
           ("js", None, "hist"), ("jsmetr", None, "hist")]


@pytest.mark.parametrize("cq", [1, 5])
@pytest.mark.parametrize("form,p,kind", BATCHED)
def test_batched_reference_matches_tpu_knn_vmap(form, p, kind, cq):
    """elementwise_batched (its plain version on the CPU) against jax.vmap of tpu_knn's
    l1/linf/lp/js blocks + pad, at Cq 1 and 5, a ragged K, +inf and 1e30 pads, and zero, NaN and
    +-inf cells."""
    q, rows, pad = _batched_inputs(kind, cq, seed=7 * cq + BATCHED.index((form, p, kind)))
    got = EW.elementwise_batched(form, *map(torch.from_numpy, (q, rows, pad)), p).numpy()
    want = _jax_batched(form, q, rows, p) + pad[:, None, :]
    assert got.shape == (B, cq, K) and got.dtype == np.float32
    assert np.isnan(want).any() and np.isinf(want).any()
    if form == "linf":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_same(got, want)


def test_batched_reference_blocks_change_nothing(monkeypatch):
    """The plain version vmaps in blocks of block_elems elements: one batch item a block gives
    the same distances as the whole batch at once."""
    q, rows, pad = map(torch.from_numpy, _batched_inputs("hist", 3, seed=5))
    whole = EW.elementwise_batched_reference("js", q, rows, pad)
    monkeypatch.setattr(EW.D, "block_elems", lambda dev: 3 * K * D)
    torch.testing.assert_close(EW.elementwise_batched_reference("js", q, rows, pad), whole, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("bad,match", [
    ("form", "unknown form"),
    ("q2d", r"q \[B, Cq, D\]"),
    ("batch", r"q \[B, Cq, D\]"),
    ("dim", r"q \[B, Cq, D\]"),
    ("pad", r"pad \[B, K\]"),
    ("dtype", "float32"),
    ("p", "p > 0"),
])
def test_batched_contract_raises(bad, match):
    """q [B, Cq, D], rows [B, K, D] and pad [B, K], all f32 on one device; lp needs p > 0."""
    q, rows, pad = map(torch.from_numpy, _batched_inputs("normal", 2, seed=3))
    form, p = "l1", None
    if bad == "form":
        form = "cosine"
    elif bad == "q2d":
        q = q[:, 0]
    elif bad == "batch":
        q = q[:2]
    elif bad == "dim":
        rows = rows[:, :, :8]
    elif bad == "pad":
        pad = pad[:, :5]
    elif bad == "dtype":
        rows = rows.double()
    elif bad == "p":
        form = "lp"
    with pytest.raises(ValueError, match=match):
        EW.elementwise_batched(form, q, rows, pad, p)


@pytest.mark.parametrize("bad,match", [("d", "multiple of 8"), ("contiguous", "contiguous")])
def test_batched_kernel_route_checks(bad, match):
    """The kernel's route takes contiguous tensors with D a positive multiple of 8 and copies
    nothing itself: it raises before it loads the kernel."""
    q, rows, pad = torch.zeros(2, 3, 16), torch.zeros(2, 40, 16), torch.zeros(2, 40)
    if bad == "d":
        q, rows = q[:, :, :12].contiguous(), rows[:, :, :12].contiguous()
    else:
        rows = rows.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match=match):
        EW._launch("batched", "l1", q, rows, pad, None)


@pytest.mark.parametrize("form,p,power", [("l1", None, 0), ("lp", 3.0, 3), ("lp", 0.7, 0), ("jsmetr", None, 0)])
def test_batched_launch_passes_shapes_and_parameters(monkeypatch, form, p, power):
    """What _launch hands tk_elementwise_batched (a spy in place of ``_lib``): the kernel form,
    LP's power, the four pointers, B, Cq, K and D, p and 1/p, the sqrt post and the stream, at Cq
    = 5 (the pair kernel, which tiles itself) and Cq = 1 (the gathered kernel); and one count on
    the batched key of the form a launch."""
    calls = []

    class Spy:
        def tk_elementwise_batched(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(EW, "_lib", Spy)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=78))
    monkeypatch.setattr(GM, "launches", dict.fromkeys(GM.launches, 0))
    for cq in (5, 1):
        q, rows, pad = torch.zeros(6, cq, 16), torch.zeros(6, 300, 16), torch.zeros(6, 300)
        out = EW._launch("batched", form, q, rows, pad, p)
        assert out.shape == (6, cq, 300)
        kform, got_power, qp, xp, pp, op, nb, got_cq, k, d, pf, inv_p, sqrt_post, stream = calls[-1]
        assert (kform, got_power) == (EW.FORMS[form][0], power)
        assert (qp, xp, pp, op) == (q.data_ptr(), rows.data_ptr(), pad.data_ptr(), out.data_ptr())
        assert (nb, got_cq, k, d, sqrt_post, stream) == (6, cq, 300, 16, int(form == "jsmetr"), 78)
        assert (pf, inv_p) == ((p, 1.0 / p) if form == "lp" else (0.0, 0.0))
    assert len(calls) == 2
    assert GM.launches == {key: 2 * int(key == EW.launch_key("batched", form)) for key in GM.launches}


# ---- JS at the edges of f32 ----

def test_js_two_huge_cells_stay_finite():
    """Two cells of 2e38 in one pair, one on each side: 1.3863068e+38 in tpu_knn and in the plain
    version, and finite and equal to it in the kernel's f32 model (quarter log2 units). The sum
    in whole log2 units, the kernel's arithmetic before, is 2e38 + 2e38: +inf."""
    q, x = np.zeros((1, 16), np.float32), np.zeros((1, 16), np.float32)
    q[0, 0], x[0, 1] = 2e38, 2e38
    want = np.float32(1.3863068e38)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    for got in (np.asarray(JD.js_div_blocked(jnp.asarray(q), jnp.asarray(x))), EW.distances("js", qt, xt).numpy(),
                _model_js(qt, xt, False).numpy()):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, [[want]], rtol=RTOL)
    np.testing.assert_allclose(_model_js(qt, xt, True).numpy(), [[np.sqrt(want)]], rtol=RTOL)
    # whole log2 units: a (La - L) = 2e38 * lg2(2 * 2e38 / 2e38) in each of the two columns
    a = torch.tensor([2e38, 2e38])
    assert torch.isinf(torch.sum(a * (torch.log2(2.0 * a.double()).float() - torch.log2(a))))


#: q [1.5e-38, 0.5, 0.5, 0...] against a valid histogram and against a signed row
FAULT2_Q = np.array([[1.5e-38, 0.5, 0.5] + [0.0] * 13], np.float32)
FAULT2_X = np.array([[0.0, 0.5, 0.5] + [0.0] * 13, [1.0, -0.5, 0.5] + [0.0] * 13], np.float32)


def _js_f64(q, x):
    """tpu_knn's documented JS formula (tpu_knn/ops/distance.py js_div_blocked) in float64:
    0.5 [a (log a - log m) + b (log b - log m)], m = (a + b) / 2, a term 0 where its value is not
    > 0, both logs of max(., 1e-38) with nothing flushed."""
    a, b = q[:, None, :].astype(np.float64), x[None, :, :].astype(np.float64)
    lm = np.log(np.maximum(0.5 * (a + b), 1e-38))
    with np.errstate(invalid="ignore"):
        ta = np.where(a > 0, a * (np.log(np.maximum(a, 1e-38)) - lm), 0.0)
        tb = np.where(b > 0, b * (np.log(np.maximum(b, 1e-38)) - lm), 0.0)
    return (0.5 * (ta + tb)).sum(-1)


def _signed_tiny_rows(seed):
    """Signed normals, and rows of tiny values (half of them in [1e-39, 4e-38), subnormal or just
    normal, against zeros and values of 0.5), with FAULT2's rows first."""
    rng = np.random.default_rng(seed)
    signed = (rng.standard_normal((40, 16)) * 2).astype(np.float32)
    tiny = np.where(rng.random((40, 16)) < 0.5, rng.uniform(1e-39, 4e-38, (40, 16)),
                    np.where(rng.random((40, 16)) < 0.5, 0.0, 0.5)).astype(np.float32)
    rows = np.concatenate([FAULT2_X, signed, tiny])
    return np.concatenate([FAULT2_Q, signed[:6], tiny[:6]]), rows


@pytest.mark.parametrize("form", ["js", "jsmetr"])
def test_js_signed_and_tiny_rows_follow_the_formula(form):
    """The port's JS on signed rows and tiny cells, decided: the plain version and the kernel's
    f32 model equal a float64 evaluation of tpu_knn's documented formula (logs clamped at 1e-38,
    unflushed) within rtol 5e-3 / atol 1e-5, e.g. 3.04e-39 and 22.05 on FAULT2's pairs."""
    q, x = _signed_tiny_rows(61)
    want = _js_f64(q, x)
    if form == "jsmetr":
        want = np.sqrt(np.maximum(want, 0.0))
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    for got in (EW.distances(form, qt, xt).numpy(), _model_js(qt, xt, form == "jsmetr").numpy()):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = EW.distances("js", qt, xt).numpy()
    np.testing.assert_allclose(plain[0, :2], [3.04e-39, 22.05], rtol=1e-3)


def test_js_tpu_knn_gives_inf_where_its_backend_flushes_the_clamp():
    """tpu_knn on FAULT2's pairs: +inf for both, the valid histogram included (XLA flushes the
    subnormal clamp 1e-38, so log(max(m, 1e-38)) is -inf for m = 7.5e-39); the port gives the
    formula's values (test_js_signed_and_tiny_rows_follow_the_formula). Pinned so that a change
    on either side shows."""
    got = np.asarray(JD.js_div_blocked(jnp.asarray(FAULT2_Q), jnp.asarray(FAULT2_X)))
    assert got.shape == (1, 2) and np.isposinf(got).all()
    assert np.isfinite(_js_f64(FAULT2_Q, FAULT2_X)).all()


# ---- every scorer of the thirteen names goes through the wrappers ----

_WRAPPERS = ("elementwise_groupmin", "elementwise_dists", "elementwise_batched")


@contextlib.contextmanager
def _spied(monkeypatch):
    """Records each wrapper call as (wrapper, form, p, Cq for the batched epilogue) and every call
    of the plain arithmetic (EW.distances) made outside a wrapper."""
    rec = SimpleNamespace(calls=[], stray=0, depth=0)
    for fn in _WRAPPERS:
        real = getattr(EW, fn)

        def spy(form, q, x, pad, p=None, _fn=fn, _real=real):
            rec.calls.append((_fn, form, p, q.shape[1] if _fn == "elementwise_batched" else None))
            rec.depth += 1
            try:
                return _real(form, q, x, pad, p)
            finally:
                rec.depth -= 1

        monkeypatch.setattr(EW, fn, spy)
    real_distances = EW.distances

    def distances(*args, **kw):
        rec.stray += rec.depth == 0
        return real_distances(*args, **kw)

    monkeypatch.setattr(EW, "distances", distances)
    yield rec


def _kinds(rec):
    """The wrappers a path called: 'groupmin', 'dists', 'gathered' (batched at Cq = 1: pass 2, the
    beam, score_rows, sw-graph's patching of one node against its candidates), 'pairs' (batched
    at Cq > 1: the heuristic's pairs)."""
    out = set()
    for fn, _, _, cq in rec.calls:
        out.add({"elementwise_groupmin": "groupmin", "elementwise_dists": "dists"}.get(fn)
                or ("gathered" if cq == 1 else "pairs"))
    return out


def _idx(name, x, method, build=None):
    idx = tpu_knn_torch.Index(name, tpu_knn_torch.Params(SPACE_PARAMS.get(name, {})), method=method, **CPU)
    idx.add_dense_batch(x)
    idx.build_index(tpu_knn_torch.Params(build or {}))
    return idx


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_thirteen_names_score_through_the_wrappers(monkeypatch, name):
    """For each elementwise name, spies on ops/elementwise's three wrappers and on its plain
    arithmetic: seq_search's pass 1 and pass 2 (two-pass route), score_rows, _score_pairs, an HNSW
    build asked for NN-descent (not eligible without an affine form, in tpu_knn too: waves, with
    their beam, wave mates and heuristic pairs) and its search, sw-graph's build and delete
    patching, VP-tree (both routes) and NAPP (both routes) call the wrappers with the name's
    form, and no call reaches EW.distances outside them."""
    form, p = ELEMENTWISE[name]
    x = np.random.default_rng(71).dirichlet(np.full(16, 0.1), 4096).astype(np.float32)
    q = x[:8] + np.float32(1e-3)
    want = {}
    with _spied(monkeypatch) as rec:
        def run(label, fn):
            rec.calls.clear()
            fn()
            want[label] = _kinds(rec)
            assert all((f, pp) == (form, p) for _, f, pp, _ in rec.calls), (label, rec.calls)

        s = _idx(name, x, "seq_search", {"chunkSize": 1024})
        run("seq_search", lambda: s.knn_query_batch(q, 2))
        assert s.method.last_route == "twopass"
        space, corpus = s.space, s.space.corpus_dict(s.method.data)
        qenc = space.encode_queries(q)
        ids = torch.from_numpy(np.random.default_rng(72).integers(-1, 300, (8, 9)).astype(np.int32))
        run("score_rows", lambda: G.score_rows(space, qenc, corpus, ids))
        run("_score_pairs", lambda: TH._score_pairs(space, qenc, 8, corpus, ids[:, :5], ids))
        small = x[:300]
        h = []
        run("hnsw nndescent", lambda: h.append(_idx(name, small, "hnsw", {"M": 4, "efConstruction": 16,
                                                                           "waveSize": 64,
                                                                           "buildAlgo": "nndescent"})))
        assert not h[0].method._nnd_eligible()
        run("hnsw search", lambda: h[0].knn_query_batch(q, 5))
        g = []
        run("sw-graph", lambda: g.append(_idx(name, small, "sw-graph", {"NN": 4, "efConstruction": 16,
                                                                         "waveSize": 64})))
        run("sw-graph delete", lambda: g[0].delete_batch(list(range(0, 300, 7)), "neighbors_only"))
        v = _idx(name, small, "vptree", {"bucketSize": 20})
        run("vptree masked", lambda: v.knn_query_batch(q, 5))
        v.set_query_time_params(tpu_knn_torch.Params(maxLeavesToVisit=3))
        run("vptree gathered", lambda: v.knn_query_batch(q, 5))
        n = _idx(name, small, "napp", {"numPivot": 16, "numPrefix": 4})
        run("napp scan", lambda: n.knn_query_batch(q, 5))
        n.set_query_time_params(tpu_knn_torch.Params(invProcAlg="gather"))
        run("napp gather", lambda: n.knn_query_batch(q, 5))
        assert rec.stray == 0
    assert want == {
        "seq_search": {"groupmin", "gathered"}, "score_rows": {"gathered"}, "_score_pairs": {"pairs"},
        "hnsw nndescent": {"gathered", "pairs", "dists"}, "hnsw search": {"gathered"},
        "sw-graph": {"gathered", "pairs", "dists"}, "sw-graph delete": {"gathered"},
        "vptree masked": {"dists", "gathered"}, "vptree gathered": {"dists", "gathered"},
        "napp scan": {"dists"}, "napp gather": {"dists", "gathered"},
    }, want
