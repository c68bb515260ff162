"""The dense spaces beyond l2 and the scalar products (l1, linf, lp; the KL,
Itakura-Saito, Jensen-Shannon, alpha-beta and Renyi divergences; dummy)
in the port (device="cpu"), held against tpu_knn on the same seeded numpy
inputs, and against tests/test_distances.py's numpy oracle in float64.

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties (a swapped pair of ids whose distances agree within the
distance tolerance).

Where the sums differ in order: the element transforms are host numpy in
both packages, so encoded rows are bit-equal; the per-row terms (sum x log
x and sum x of the KL family, sum log x of Itakura-Saito, sum x^(a+b) of
alpha-beta) are f32 sums over D in torch's order in the port and in
numpy's pairwise order in tpu_knn. :func:`test_block_matches_tpu_knn`
holds them within 4 ulps of the largest term of the batch (at most 2
found on these inputs); the products are IEEE f32 matmuls in both, also
summed in different orders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn.core.registry import create_space as j_create_space  # noqa: E402
from tpu_knn.ops import topk as JT  # noqa: E402
from test_distances import _np_distances  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind as TDataKind, DataStore as TDataStore  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError  # noqa: E402
from tpu_knn_torch.core.registry import create_space as t_create_space  # noqa: E402
from tpu_knn_torch.ops import topk as TT  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
F32_ULP = 2.0**-23

#: every name tpu_knn/spaces/dense.py registers beyond the five ported before,
#: with the parameters the test takes, and the name of tests/test_distances.py's
#: oracle for it
SPACES = {
    "l1": ({}, "l1"),
    "linf": ({}, "linf"),
    "lp": ({"p": 3.0}, "lp"),
    "kldivfast": ({}, "kldivfast"),
    "kldivfastrq": ({}, "kldivfastrq"),
    "kldivgenfast": ({}, "kldivgenfast"),
    "kldivgenfastrq": ({}, "kldivgenfastrq"),
    "kldivgenslow": ({}, "kldivgenfast"),
    "itakurasaitofast": ({}, "itakurasaitofast"),
    "itakurasaitoslow": ({}, "itakurasaitofast"),
    "itakurasaitofastrq": ({}, "itakurasaitofastrq"),
    "js_div_slow": ({}, "js_div_slow"),
    "jsdivslow": ({}, "js_div_slow"),
    "js_div_fast": ({}, "js_div_slow"),
    "jsdivfast": ({}, "js_div_slow"),
    "js_div_fast_approx": ({}, "js_div_slow"),
    "jsdivfastapprox": ({}, "js_div_slow"),
    "jsmetrslow": ({}, "jsmetrfast"),
    "jsmetrfast": ({}, "jsmetrfast"),
    "jsmetrfastapprox": ({}, "jsmetrfast"),
    "abdiv_fast": ({"alpha": 1.2, "beta": 0.7}, "abdiv_fast"),
    "abdiv_slow": ({"alpha": 1.2, "beta": 0.7}, "abdiv_fast"),
    "renyidiv_fast": ({"alpha": 0.75}, "renyidiv_fast"),
    "renyidiv_slow": ({"alpha": 0.75}, "renyidiv_fast"),
    "dummy": ({}, "l1"),
}
NAMES = sorted(SPACES)


def _histograms(n, d, seed):
    """Dirichlet(0.1) rows on the simplex in f32: many components round to
    0, so the encodes reach their 1e-30 clamp."""
    return np.random.default_rng(seed).dirichlet(np.full(d, 0.1), n).astype(np.float32)


def _index(pkg, name, x, method="seq_search", build=None):
    idx = pkg.Index(name, pkg.Params(SPACES[name][0]), method=method, **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_dense_batch(x)
    if build is not None:
        idx.build_index(pkg.Params(build))
    return idx


def _assert_same_knn(ref, got):
    """Distances within the tolerance; an id the port returns where the
    reference returns another is in the reference's row, or ties the
    reference's last distance (a different id at the cut)."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, -1], rtol=RTOL, atol=ATOL), (r, c)


def _recall(ids, gold, k):
    return float(np.mean([len(set(a[a >= 0]) & set(b)) / k for a, b in zip(np.asarray(ids), gold)]))


def _encode_both(name, x):
    params = SPACES[name][0]
    js = j_create_space(name, tpu_knn.Params(params))
    ts = t_create_space(name, tpu_knn_torch.Params(params), device="cpu")
    jstore, tstore = DataStore(DataKind.DENSE), TDataStore(TDataKind.DENSE)
    jstore.add_dense_batch(x)
    tstore.add_dense_batch(x)
    return js, ts, js.encode_dataset(jstore), ts.encode_dataset(tstore)


@pytest.mark.parametrize("name", NAMES)
def test_block_matches_tpu_knn(name, rng):
    """encode + block against tpu_knn's block and against the float64
    numpy oracle (positive rows), and against tpu_knn on histograms whose
    zeros reach the 1e-30 clamp; one-pair distances (pairwise) too."""
    params, oracle = SPACES[name]
    d = 24
    q = rng.random((5, d)).astype(np.float32) + 0.1
    x = rng.random((17, d)).astype(np.float32) + 0.1
    want = _np_distances(
        oracle, q.astype(np.float64), x.astype(np.float64),
        p=params.get("p"), alpha=params.get("alpha"), beta=params.get("beta"),
    )
    for xs, qs, check_oracle in ((x, q, True), (_histograms(17, d, 5), _histograms(5, d, 6), False)):
        js, ts, jd, td = _encode_both(name, xs)
        np.testing.assert_array_equal(td.vecs.numpy(), np.asarray(jd.vecs))  # host transforms: bit-equal
        jq, tq = js.encode_queries(qs), ts.encode_queries(qs)
        assert sorted(jq) == sorted(tq)
        np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
        for a, b in ((td.row_term, jd.row_term), (tq.get("q_term"), jq.get("q_term"))):
            assert (a is None) == (b is None)
            if a is not None:  # f32 sums in torch's order against numpy's
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=4 * F32_ULP, atol=4 * F32_ULP * np.abs(b).max())
        got = ts.block(tq, ts.slice_data(td, 0, td.ids.shape[0])).numpy()
        ref = np.asarray(js.block(jq, js.slice_data(jd, 0, jd.ids.shape[0])))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        if check_oracle:
            np.testing.assert_allclose(got[:, :17], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.pairwise(qs[0], xs[3]), js.pairwise(qs[0], xs[3]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_knn_both_routes_and_saved_index_match_tpu_knn(tmp_path, name):
    """knn_query_batch on the single-pass route (3000 rows) and on the
    two-pass route (8192 rows >= 8*(k+2)*128 at k=4), with the block-scan
    pass 1 for the spaces with no affine form and the group-min kernel's
    plain version for the others; the single-pass index either package
    saves loads in the other and answers the same; get_distance agrees."""
    x = _histograms(8192, 32, 11)
    q = _histograms(16, 32, 12)
    for n, k, route in ((3000, 10, "single"), (8192, 4, "twopass")):
        j, t = _index(tpu_knn, name, x[:n]), _index(tpu_knn_torch, name, x[:n])
        ref, got = j.knn_query_batch(q, k), t.knn_query_batch(q, k)
        assert t.method.last_route == route
        _assert_same_knn(ref, got)
        if route == "single":
            np.testing.assert_allclose(t.get_distance(3, 17), j.get_distance(3, 17), rtol=RTOL, atol=ATOL)
            for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
                path = str(tmp_path / f"{reader.__name__}_reads")
                src.save(path)
                back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
                assert back.get_space_type() == name
                _assert_same_knn(ref, back.knn_query_batch(q, k))


@pytest.mark.parametrize("name", ["l1", "kldivgenfast", "jsdivfast"])
def test_range_matches_tpu_knn(name):
    """range_query_batch at the median 10th-neighbour distance: equal hit
    sets except within the tolerance of the radius."""
    x = _histograms(3000, 32, 31)
    q = _histograms(12, 32, 32)
    j, t = _index(tpu_knn, name, x), _index(tpu_knn_torch, name, x)
    d10, _ = j.knn_query_batch(q, 10)
    radius = float(np.median(d10[:, -1]))
    for rj, rt in zip(j.range_query_batch(q, radius), t.range_query_batch(q, radius)):
        assert np.all(np.diff(rt.dists) >= 0) and rt.ids.dtype == np.int32
        mj, mt = dict(zip(rj.ids, rj.dists)), dict(zip(rt.ids, rt.dists))
        for i in set(mj) ^ set(mt):
            assert abs(mj.get(i, mt.get(i)) - radius) <= RTOL * radius + ATOL
        for i in set(mj) & set(mt):
            np.testing.assert_allclose(mt[i], mj[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,params", [
    ("lp", {"p": 0.0}),
    ("lp", {"p": -1.5}),
    ("abdiv_fast", {"alpha": 0.0, "beta": 1.0}),
    ("abdiv_slow", {"alpha": 1.0, "beta": 0.0}),
    ("abdiv_fast", {"alpha": 0.5, "beta": -0.5}),
    ("renyidiv_fast", {"alpha": 1.0}),
    ("renyidiv_slow", {"alpha": 0.0}),
    ("renyidiv_fast", {"alpha": -0.25}),
])
def test_parameter_errors_equal_tpu_knn(name, params):
    with pytest.raises(tpu_knn.InvalidArgumentError) as je:
        tpu_knn.Index(name, tpu_knn.Params(params))
    with pytest.raises(InvalidArgumentError) as te:
        tpu_knn_torch.Index(name, tpu_knn_torch.Params(params), **CPU)
    assert str(te.value) == str(je.value)


def test_factored_divergence_blocks_equal_tpu_knn():
    """kldiv_blocked and itakura_saito_blocked, the factored forms no space
    calls in either package, on the same encoded rows."""
    from tpu_knn.ops import distance as JD
    from tpu_knn_torch.ops import distance as TD

    q, x = _histograms(6, 24, 51) + 0.01, _histograms(9, 24, 52) + 0.01
    lx, ix = np.log(x), 1.0 / x
    qlq, lqs, lxs = (q * np.log(q)).sum(1), np.log(q).sum(1), np.log(x).sum(1)
    t = torch.from_numpy
    np.testing.assert_allclose(
        TD.kldiv_blocked(t(q), t(lx), t(qlq)).numpy(), np.asarray(JD.kldiv_blocked(q, lx, qlq)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TD.itakura_saito_blocked(t(q), t(ix), t(lqs), t(lxs), 24).numpy(),
        np.asarray(JD.itakura_saito_blocked(q, ix, lqs, lxs, 24)), rtol=RTOL, atol=ATOL)


def test_mask_padding_equals_tpu_knn():
    d = np.random.default_rng(3).standard_normal((5, 40)).astype(np.float32)
    for count in (0, 17, 40):
        ref = np.asarray(JT.mask_padding(d, count, 40))
        np.testing.assert_array_equal(TT.mask_padding(torch.from_numpy(d), count, 40).numpy(), ref)


#: small enough for the CPU: the wave build scores every wave row's candidate
#: pairs on every level, [C, C, D] per row (mult=0.25: few levels), and the
#: distances that do not factor (l1, jsdivfast) materialize those in torch,
#: where XLA fuses them
HNSW_BUILD = dict(M=6, efConstruction=20, waveSize=64, waveMates=2, mult=0.25, seed=0)


@pytest.mark.parametrize("name", ["l1", "kldivgenfast", "jsdivfast"])
def test_hnsw_matches_tpu_knn(tmp_path, name):
    """The wave build at 1024 x 32 (the generic _score_pairs and the
    per-query score_gathered for l1 and jsdivfast; the affine branches for
    kldivgenfast, which keeps the waves: no rows_as_queries): recall@10
    within 0.02 of tpu_knn's against the exact scan, check_graph zero, and
    a graph either package saved loads and searches in the other."""
    x = _histograms(1024, 32, 41)
    q = _histograms(48, 32, 42)
    _, gold = _index(tpu_knn_torch, name, x).knn_query_batch(q, 10)
    j = _index(tpu_knn, name, x, "hnsw", HNSW_BUILD)
    t = _index(tpu_knn_torch, name, x, "hnsw", HNSW_BUILD)
    assert t.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    l0j, l0t = np.asarray(j.method.graph["level0"])[:1024], t.method.graph["level0"].numpy()[:1024]
    share = float(np.mean([set(a) == set(b) for a, b in zip(l0j, l0t)]))
    print(f"{name}: level-0 rows with tpu_knn's neighbour set {share:.4f}")
    j.set_query_time_params(tpu_knn.Params(efSearch=50))
    t.set_query_time_params(tpu_knn_torch.Params(efSearch=50))
    rj, rt = _recall(j.knn_query_batch(q, 10)[1], gold, 10), _recall(t.knn_query_batch(q, 10)[1], gold, 10)
    print(f"{name}: recall@10 at efSearch=50, tpu_knn {rj:.4f}, port {rt:.4f}")
    assert abs(rj - rt) <= 0.02, (rj, rt)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / f"{reader.__name__}_reads")
        src.save(path)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        back.set_query_time_params(reader.Params(efSearch=50))
        _assert_same_knn(src.knn_query_batch(q, 10), back.knn_query_batch(q, 10))


@pytest.mark.slow
def test_hnsw_kldivgenfast_recall_at_the_chip_settings():
    """chip_smoke.py phase 17's HNSW cell (M=16, efConstruction=200,
    waveSize=1024 over its Dirichlet(0.1) histograms) at 3000 rows: the
    port's recall@10 equals tpu_knn's at every efSearch, so the low recall
    on these i.i.d. rows is the algorithm's on this data. A larger build
    (~90 s), so marked slow."""
    g = np.random.default_rng(0).standard_gamma(0.1, size=(3000 + 256, 128), dtype=np.float32)
    g /= g.sum(axis=1, keepdims=True)
    x, q = g[:3000], g[3000:]
    _, gold = _index(tpu_knn_torch, "kldivgenfast", x).knn_query_batch(q, 10)
    build = dict(M=16, efConstruction=200, waveSize=1024)
    j = _index(tpu_knn, "kldivgenfast", x, "hnsw", build)
    t = _index(tpu_knn_torch, "kldivgenfast", x, "hnsw", build)
    for ef in (20, 100, 400):
        j.set_query_time_params(tpu_knn.Params(efSearch=ef))
        t.set_query_time_params(tpu_knn_torch.Params(efSearch=ef))
        rj, rt = _recall(j.knn_query_batch(q, 10)[1], gold, 10), _recall(t.knn_query_batch(q, 10)[1], gold, 10)
        print(f"kldivgenfast 3000 rows, efSearch={ef}: recall@10 tpu_knn {rj:.4f}, port {rt:.4f}")
        assert abs(rj - rt) <= 0.02, (ef, rj, rt)
