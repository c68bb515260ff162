"""The port's eval/metrics.py and eval/gold_standard.py against tpu_knn's
on the same inputs, and gold-standard caches read across packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
from tpu_knn.eval import gold_standard as JG, metrics as JM  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn_torch.core.errors import DataIOError  # noqa: E402
from tpu_knn_torch.core.registry import create_space  # noqa: E402
from tpu_knn_torch.eval import GoldStandard, class_accuracy, per_query_metrics, summarize  # noqa: E402
from tpu_knn_torch.eval import metrics as TM  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402


def _results(seed, q=40, k=10):
    """Random exact and approximate results with -1/inf padding, ties and
    approximate answers that are never better than the exact ones."""
    rng = np.random.default_rng(seed)
    ex_d = np.sort(rng.integers(0, 30, (q, k)).astype(np.float32) / 4, axis=1)
    ex_i = np.stack([rng.permutation(100)[:k] for _ in range(q)]).astype(np.int32)
    ap_d = np.sort(ex_d + rng.integers(0, 3, (q, k)) / 4, axis=1).astype(np.float32)
    ap_i = np.where(rng.random((q, k)) < 0.7, ex_i, rng.integers(100, 200, (q, k))).astype(np.int32)
    for d, i, rows in ((ex_d, ex_i, [1, 2]), (ap_d, ap_i, [2, 3, 4])):
        for r in rows:  # padded tails, one query with nothing at all
            c = 0 if r in (2, 4) else k - 3
            d[r, c:], i[r, c:] = np.inf, -1
    return ex_d, ex_i, ap_d, ap_i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_tpu_knns(seed):
    ex_d, ex_i, ap_d, ap_i = _results(seed)
    want = JM.per_query_metrics(ex_d, ex_i, ap_d, ap_i)
    got = per_query_metrics(ex_d, ex_i, ap_d, ap_i)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert summarize(got) == JM.summarize(want)
    assert (TM._REL_TOL, TM._ABS_TOL) == (JM._REL_TOL, JM._ABS_TOL)


def test_perfect_and_degraded_metrics():
    """tests/test_eval.py's two cases on the port."""
    ex_d, ex_i = np.asarray([[0.0, 1.0, 2.0]]), np.asarray([[5, 7, 9]])
    m = per_query_metrics(ex_d, ex_i, ex_d.copy(), ex_i.copy())
    assert (m["recall"][0], m["recall@1"][0], m["number_closer"][0]) == (1.0, 1.0, 0.0)
    assert m["precision_of_approx"][0] == pytest.approx(1.0) and m["log_rel_pos_error"][0] == pytest.approx(0.0)
    m = per_query_metrics(ex_d, ex_i, np.asarray([[1.0, 2.0, 4.0]]), np.asarray([[7, 9, 11]]))
    assert m["recall"][0] == pytest.approx(2 / 3) and m["number_closer"][0] == 1.0
    assert m["log_rel_pos_error"][0] > 0


def test_invariant_violation_raises():
    ex_d, ex_i = np.asarray([[1.0, 2.0]]), np.asarray([[5, 7]])
    ap_d, ap_i = np.asarray([[0.5, 2.0]]), np.asarray([[3, 7]])  # "better than exact"
    for per_query in (per_query_metrics, JM.per_query_metrics):
        with pytest.raises(AssertionError, match="approximate query should not"):
            per_query(ex_d, ex_i, ap_d, ap_i)
    got = per_query_metrics(ex_d, ex_i, ap_d, ap_i, check_invariant=False)
    want = JM.per_query_metrics(ex_d, ex_i, ap_d, ap_i, check_invariant=False)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_class_accuracy_equal():
    rng = np.random.default_rng(3)
    ex = rng.integers(-1, 4, (30, 7))
    ap = np.where(rng.random((30, 7)) < 0.6, ex, rng.integers(-1, 4, (30, 7)))
    ap[0] = -1  # no label at all
    np.testing.assert_array_equal(class_accuracy(ex, ap), JM.class_accuracy(ex, ap))


def _gold_pair(x, space="l2"):
    jst = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.DENSE)
    jst.add_dense_batch(x)
    tst = DataStore(DataKind.DENSE)
    tst.add_dense_batch(x)
    dim = {"dim": x.shape[1]}
    return (JG.GoldStandard(tpu_knn.core.registry.create_space(space, dim), jst),
            GoldStandard(create_space(space, dim, device="cpu"), tst))


@pytest.mark.parametrize("space", ["l2", "cosinesimil"])
def test_gold_standard_matches_tpu_knn(space):
    x = clustered(600, 8, seed=4)
    q = x[:6] + 0.01
    jg, tg = _gold_pair(x, space)
    (jd, ji), (td, ti) = jg.compute_knn(q, 5), tg.compute_knn(q, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=5e-3, atol=1e-5)
    assert (ti[:, 0] == np.arange(6)).all() and tg.method.name == "seq_search"
    r = float(np.median(td[:, -1]))
    for (a_i, a_d), (b_i, b_d) in zip(tg.compute_range(q, r), jg.compute_range(q, r)):
        np.testing.assert_array_equal(a_i, b_i)
        np.testing.assert_allclose(a_d, b_d, rtol=5e-3, atol=1e-5)


def test_gold_cache_crosses_packages(tmp_path):
    x = clustered(200, 8, seed=5)
    jg, tg = _gold_pair(x)
    with pytest.raises(DataIOError):
        tg.save_cache(str(tmp_path / "early"))
    td, ti = tg.compute_knn(x[:5], 3)
    jg.compute_knn(x[:5], 3)
    tg.save_cache(str(tmp_path / "port.npz"))
    jg.save_cache(str(tmp_path / "jax.npz"))
    for path, (wd, wi) in (("port", (td, ti)), ("jax", (jg.dists, jg.ids))):
        for loader in (GoldStandard.load_cache, JG.GoldStandard.load_cache):
            d, i = loader(str(tmp_path / path))  # ".npz" appended when missing
            np.testing.assert_array_equal(d, wd)
            np.testing.assert_array_equal(i, wi)
            assert d.dtype == wd.dtype and i.dtype == wi.dtype
    with pytest.raises(DataIOError):
        GoldStandard.load_cache(str(tmp_path / "nothing.npz"))


def test_tune_hnsw_ef_equals_tpu_knn():
    """eval/tune.py's HNSW tuner on a graph built alike by both packages
    (clustered rows, continuous): the same efSearch and recall, the
    method's efSearch restored afterwards."""
    import tpu_knn_torch
    from tpu_knn.eval.tune import tune_hnsw_ef as jtune
    from tpu_knn_torch.eval.tune import tune_hnsw_ef as ttune

    x = clustered(800, 16, n_clusters=30, seed=11)
    out = []
    for pkg, tune, kw in ((tpu_knn, jtune, {}), (tpu_knn_torch, ttune, {"device": "cpu"})):
        idx = pkg.Index("l2", pkg.Params(dim=16), **kw)
        idx.add_dense_batch(x)
        idx.build_index(pkg.Params(M=6, efConstruction=20, waveSize=64))
        old = idx.method.ef_search
        out.append(tune(idx.method, idx.store, k=5, desired_recall=0.97, sample=60))
        assert idx.method.ef_search == old
    assert out[0]["efSearch"] == out[1]["efSearch"] and out[0]["met"] == out[1]["met"]
    assert out[0]["recall"] == pytest.approx(out[1]["recall"], abs=1e-9)
