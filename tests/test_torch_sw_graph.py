"""sw-graph (small_world_rand) in the port (device="cpu"): the five tests of
tests/test_sw_graph.py replayed on the port, level 0 held against tpu_knn
after the build, after add_batch and after each delete strategy on the same
seeded continuous rows, files with deletions crossing the packages both
ways, and the incremental API (Index._mark_dirty, delete_batch).

One difference by design: when two deleted friends of a node pick the same
replacement, tpu_knn links it twice and the port frees the second slot
(the reference's link() never adds a friend twice); the graphs are compared
with tpu_knn's second copies freed the same way."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch import Index, Params  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError, RuntimeNmsError  # noqa: E402
from tpu_knn_torch.eval.datasets import sift_like  # noqa: E402

CPU = {"device": "cpu"}


def _close(d2, d1, ids, queries_ids):
    """Distances within rtol 5e-3 / atol 1e-5, except a query's distance to
    itself: there the l2 norm identity leaves sqrt of an f32 cancellation
    (up to ~0.25 on sift_like's magnitudes) in either package."""
    own = ids == np.asarray(queries_ids)[:, None]
    np.testing.assert_allclose(d2[~own], d1[~own], rtol=5e-3, atol=1e-5)
    assert (np.abs(d2[own]) <= 0.5).all()


def _data(rng, n=120, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _sw(x, build, pkg=tpu_knn_torch):
    idx = pkg.Index("l2", pkg.Params(dim=x.shape[1]), method="sw-graph", **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_dense_batch(x)
    idx.build_index(pkg.Params(build))
    return idx


def test_sw_graph_search_quality(rng):
    x = _data(rng)
    idx = _sw(x, dict(NN=8, efConstruction=40, waveSize=32))
    idx.set_query_time_params(Params(efSearch=60))
    d, ids = idx.knn_query_batch(x[:20], 5)
    assert np.all(ids[:, 0] == np.arange(20))
    ex = Index("l2", Params(dim=16), method="seq_search", **CPU)
    ex.add_dense_batch(x)
    de, ie = ex.knn_query_batch(x[:20], 5)
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, ie)]) >= 0.9


def test_sw_graph_incremental_add(rng):
    x, extra = _data(rng, 80), _data(rng, 40)
    idx = _sw(x, dict(NN=8, efConstruction=40, waveSize=32))
    idx.set_query_time_params(Params(efSearch=60))
    idx.add_dense_batch(extra)
    assert idx.built  # absorbed in place, no rebuild
    assert idx.data_qty() == 120 and idx.method.data_qty() == 120
    d, ids = idx.knn_query_batch(extra[:10], 3)
    assert np.all(ids[:, 0] == 80 + np.arange(10))
    assert np.allclose(d[:, 0], 0, atol=5e-3)  # norm-identity f32 floor after sqrt


@pytest.mark.parametrize("strategy", ["none", "neighbors_only"])
def test_sw_graph_delete(rng, strategy):
    x = _data(rng, 100)
    idx = _sw(x, dict(NN=8, efConstruction=40, waveSize=32))
    idx.set_query_time_params(Params(efSearch=80))
    doomed = [5, 17, 42]
    idx.delete_batch(doomed, strategy=strategy)
    assert idx.method.data_qty() == 97
    d, ids = idx.knn_query_batch(x, 4)
    assert not np.isin(ids, doomed).any()
    keep = np.setdiff1d(np.arange(100), doomed)
    assert np.mean(ids[keep, 0] == keep) >= 0.95
    assert idx.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}


def test_sw_graph_delete_then_add(rng):
    x = _data(rng, 60)
    idx = _sw(x, dict(NN=6, efConstruction=30, waveSize=16))
    idx.delete_batch([0, 1], strategy="neighbors_only")
    idx.add_dense_batch(_data(rng, 20))
    assert idx.method.data_qty() == 78
    d, ids = idx.knn_query_batch(x[2:6], 2)
    assert np.all(ids[:, 0] == np.arange(2, 6))
    assert not np.isin(ids, [0, 1]).any()


def test_sw_graph_persistence_with_deletions(tmp_path, rng):
    x = _data(rng, 60)
    idx = _sw(x, dict(NN=6, efConstruction=30, waveSize=16))
    idx.delete_batch([3, 7], strategy="neighbors_only")
    p = str(tmp_path / "sw")
    idx.save(p)
    idx2 = Index.load(p, **CPU)
    assert idx2.method.data_qty() == 58
    d, ids = idx2.knn_query_batch(x[:20], 4)
    assert not np.isin(ids, [3, 7]).any()


def _level0(idx):
    g = idx.method.graph["level0"]
    return g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)


def _free_repeats(adj):
    """Each row with every repeated id after its first slot set to -1."""
    out = adj.copy()
    for r in range(out.shape[0]):
        seen = set()
        for c in range(out.shape[1]):
            v = out[r, c]
            if v >= 0 and v in seen:
                out[r, c] = -1
            seen.add(v)
    return out


@pytest.mark.parametrize("strategy", ["none", "neighbors_only"])
def test_graphs_equal_tpu_knn_after_build_add_and_delete(strategy):
    """sift_like rows (continuous): 1,000 built, 200 added, 60 deleted, 24
    more added; level 0 equal to tpu_knn's at every step, array for array
    (with neighbors_only: neighbour sets, tpu_knn's repeated replacements
    freed), results equal after."""
    x = sift_like(1224, 32, seed=4)
    doomed = np.random.default_rng(5).choice(1200, 60, replace=False)
    idxs = [_sw(x[:1000], dict(NN=8, efConstruction=40, waveSize=128), pkg) for pkg in (tpu_knn, tpu_knn_torch)]
    np.testing.assert_array_equal(_level0(idxs[1]), _level0(idxs[0]))
    for idx in idxs:
        idx.add_dense_batch(x[1000:1200])
    assert idxs[1].built
    np.testing.assert_array_equal(_level0(idxs[1]), _level0(idxs[0]))
    for idx in idxs:
        idx.delete_batch(doomed, strategy=strategy)
    # a freed slot can take a later reverse link earlier in its row: equal as sets
    np.testing.assert_array_equal(np.sort(_level0(idxs[1]), axis=1), np.sort(_free_repeats(_level0(idxs[0])), axis=1))
    if strategy == "none":
        np.testing.assert_array_equal(_level0(idxs[1]), _level0(idxs[0]))
    assert idxs[1].method._entry == idxs[0].method._entry
    for idx in idxs:
        idx.add_dense_batch(x[1200:])
    if strategy == "none":  # no repeats to free: the graphs stay equal array for array
        np.testing.assert_array_equal(_level0(idxs[1]), _level0(idxs[0]))
    assert idxs[1].method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    for idx, pkg in zip(idxs, (tpu_knn, tpu_knn_torch)):
        idx.set_query_time_params(pkg.Params(efSearch=40))
    (d1, i1), (d2, i2) = (idx.knn_query_batch(x[:64], 5) for idx in idxs)
    assert not np.isin(i2, doomed).any()
    if strategy == "none":
        np.testing.assert_array_equal(i2, i1)
        _close(d2, d1, i1, np.arange(64))


def test_files_with_deletions_cross_both_ways(tmp_path):
    x = sift_like(400, 16, seed=6)
    doomed = [3, 50, 51, 200]
    for src_pkg, dst_pkg in ((tpu_knn, tpu_knn_torch), (tpu_knn_torch, tpu_knn)):
        src = _sw(x, dict(NN=6, efConstruction=30, waveSize=64), src_pkg)
        src.delete_batch(doomed, strategy="none")
        src.set_query_time_params(src_pkg.Params(efSearch=40))
        p = str(tmp_path / f"sw_{src_pkg.__name__}")
        src.save(p)
        back = dst_pkg.Index.load(p, **(CPU if dst_pkg is tpu_knn_torch else {}))
        back.set_query_time_params(dst_pkg.Params(efSearch=40))
        assert back.method.data_qty() == 396
        np.testing.assert_array_equal(_level0(back), _level0(src))
        (d0, i0), (d1, i1) = src.knn_query_batch(x[:32], 4), back.knn_query_batch(x[:32], 4)
        assert not np.isin(i1, doomed).any()
        np.testing.assert_array_equal(i1, i0)
        _close(d1, d0, i0, np.arange(32))


def test_incremental_api():
    """_mark_dirty: a method without incremental maintenance rebuilds on the
    next query; delete_batch raises for it, and for an unknown strategy."""
    x = sift_like(200, 16, seed=7)
    h = Index("l2", Params(dim=16), **CPU)
    h.add_dense_batch(x[:150])
    h.build_index(Params(M=6, efConstruction=20))
    h.add_dense_batch(x[150:])
    assert not h.built
    with pytest.raises(RuntimeNmsError):
        h.delete_batch([0])
    assert h.built and h.method.data.count == 200  # delete_batch built it first
    sw = _sw(x, dict(NN=6, efConstruction=20))
    with pytest.raises(InvalidArgumentError):
        sw.delete_batch([0], strategy="all")
    with pytest.raises(InvalidArgumentError):
        sw.delete_batch([200])
    sw.delete_batch([])
    assert sw.method.data_qty() == 200
    # sw-graph's query-time default efSearch is NN (small_world_rand.cc:366-427)
    assert sw.method.ef_search == 6
    sw.set_query_time_params(Params(efSearch=30))
    sw.set_query_time_params(None)
    assert sw.method.ef_search == 6
