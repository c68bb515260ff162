"""The port's experiment harness and reports (tpu_knn_torch.eval.experiments
and eval.report, device="cpu") against tpu_knn's on the same seeded inputs:
bootstrap split positions, Experiments.run / run_range and
run_full_experiment quality rows (every column but the timings),
MetaAnalysis, intrinsic dimensionality (rtol 1e-5) and format_table."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn.eval as JE  # noqa: E402
import tpu_knn_torch  # noqa: E402
import tpu_knn_torch.eval as TE  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402

#: columns that are wall-clock timings (compared for presence only)
TIMED = {"qps", "query_time_ms"}
PKGS = ((tpu_knn, JE), (tpu_knn_torch, TE))
HNSW = dict(M=8, efConstruction=40, waveSize=64)


def _space(pkg, dim=12, name="l2"):
    kw = {"device": "cpu"} if pkg is tpu_knn_torch else {}
    return pkg.core.registry.create_space(name, pkg.Params(dim=dim), **kw)


def _store(pkg, x, labels=None):
    st = pkg.core.dataset.DataStore(pkg.core.dataset.DataKind.DENSE)
    st.add_dense_batch(x, labels=labels)
    return st


def _factory(pkg, method, params):
    return lambda sp: pkg.core.registry.create_method(method, sp, pkg.Params(params))


def _same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for key in ra:
            if key in TIMED:
                continue
            va, vb = ra[key], rb[key]
            if isinstance(va, dict) and "mean" in va:
                np.testing.assert_allclose([vb["mean"], vb["std"]], [va["mean"], va["std"]], rtol=1e-6,
                                           err_msg=key)
            elif isinstance(va, float):
                np.testing.assert_allclose(vb, va, rtol=1e-6, err_msg=key)
            else:
                assert va == vb, key


@pytest.fixture(scope="module")
def data():
    x = clustered(600, 12, seed=61)
    return x[:560], x[560:]


@pytest.mark.parametrize("n,qty,sets,seed", [(200, 20, 2, 0), (57, 100, 3, 5), (1, 5, 1, 2)])
def test_split_positions_equal(n, qty, sets, seed):
    j = list(JE.ExperimentConfig(test_set_qty=sets, query_qty=qty, seed=seed).split(n))
    t = list(TE.ExperimentConfig(test_set_qty=sets, query_qty=qty, seed=seed).split(n))
    assert len(j) == len(t) == sets
    for (ja, jb), (ta, tb) in zip(j, t):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("method,params", [("seq_search", {}), ("hnsw", HNSW)])
def test_experiments_run_rows_equal(data, method, params):
    """Quality rows of a kNN sweep (two query-time sets for hnsw), with
    class accuracy from the labels; dist_comps equal."""
    x, q = data
    labels = np.arange(len(x)) % 5
    qsets = [None] if method == "seq_search" else [{"efSearch": 10}, {"efSearch": 40}]
    rows = []
    for pkg, ev in PKGS:
        sp = _space(pkg)
        st = _store(pkg, x, labels)
        m = _factory(pkg, method, params)(sp)
        m.create_index(st)
        rows.append(ev.Experiments(sp, st, q, k=5).run(m, qsets))
    _same_rows(*rows)
    assert "class_accuracy" in rows[1][0] and rows[1][0]["recall"] > 0.5


def test_experiments_run_range_rows_equal(data):
    x, q = data
    rows = []
    for pkg, ev in PKGS:
        sp = _space(pkg)
        st = _store(pkg, x)
        m = _factory(pkg, "seq_search", {})(sp)
        m.create_index(st)
        ex = ev.Experiments(sp, st, q, k=5)
        rows.append(ex.run_range(m, 1.5, [None]) + ex.run_range(m, 0.5, [None]))
    _same_rows(*rows)
    assert rows[1][0]["mean_result_size"] > 0 and rows[1][0]["recall"] == 1.0


def test_run_full_experiment_equal(data):
    """Split -> build -> sweep -> aggregate over 2 bootstrap sets: hnsw kNN,
    and seq_search kNN and range (hnsw has no range search)."""
    x = np.concatenate(data)
    knn, rng_ = [], []
    for pkg, ev in PKGS:
        cfg = ev.ExperimentConfig(test_set_qty=2, query_qty=30, seed=3)
        knn.append(ev.run_full_experiment(_space(pkg), _store(pkg, x), _factory(pkg, "hnsw", HNSW), cfg,
                                          [{"efSearch": 20}], k=5))
        rng_.append(ev.run_full_experiment(_space(pkg), _store(pkg, x), _factory(pkg, "seq_search", {}), cfg,
                                           [None], k=5, range_radii=(1.5, 0.5)))
    _same_rows(*knn)
    (jk, jr), (tk, tr) = rng_
    _same_rows(jk, tk)
    assert set(jr) == set(tr) == {1.5, 0.5}
    for r in jr:
        _same_rows(jr[r], tr[r])


def test_meta_analysis_equal():
    rng = np.random.default_rng(62)
    rows = [{"recall": float(r), "qps": float(v), "n": int(i), "tag": "a", "inf": float("inf")}
            for i, (r, v) in enumerate(zip(rng.random(5), rng.random(5) * 1e4))]
    aggs = []
    for _, ev in PKGS:
        m = ev.MetaAnalysis()
        for r in rows:
            m.add(r)
        aggs.append(m.aggregate())
    assert aggs[0].keys() == aggs[1].keys() == {"recall", "qps", "n", "inf"}
    for key in aggs[0]:
        for stat in ("mean", "std", "ci95"):
            np.testing.assert_allclose(aggs[1][key][stat], aggs[0][key][stat], rtol=1e-12)
    assert TE.MetaAnalysis().aggregate() == {}


@pytest.mark.parametrize("name,sample", [("l2", 10000), ("cosinesimil", 400), ("l1", 2500)])
def test_intrinsic_dimensionality(data, name, sample):
    x = data[0]
    r = [ev.compute_intrinsic_dimensionality(_space(pkg, name=name), _store(pkg, x), sample_qty=sample)
         for pkg, ev in PKGS]
    assert r[0]["sample_qty"] == r[1]["sample_qty"] > 0
    for key in ("intrinsic_dim", "dist_mean", "dist_sigma"):
        np.testing.assert_allclose(r[1][key], r[0][key], rtol=1e-5, err_msg=key)
    rep = TE.report_intrinsic_dimensionality("x", _space(tpu_knn_torch, name=name), _store(tpu_knn_torch, x),
                                             sample)
    assert rep == r[1]


def test_intrinsic_dimensionality_nan_is_fatal():
    """A NaN distance (an +inf coordinate under the l2 norm identity) raises
    before the finite filter could drop it, in both packages."""
    x = clustered(64, 4, seed=63)
    x[3, 1] = np.inf
    for pkg, ev in PKGS:
        with pytest.raises(RuntimeError, match="NAN"):
            ev.compute_intrinsic_dimensionality(_space(pkg, dim=4), _store(pkg, x), sample_qty=4096, seed=0)


def test_format_table_identical():
    rows = [{"params": "{'efSearch': 10}", "recall": 0.98765, "qps": 12345.678, "n": 3, "none": None},
            {"params": "{}", "recall": 1.0, "qps": 7.0, "n": 10, "none": None}]
    for cols in (None, ["params", "recall", "n", "missing"]):
        assert TE.format_table(rows, cols) == JE.format_table(rows, cols)
    assert TE.format_table([]) == JE.format_table([]) == "(no results)"
