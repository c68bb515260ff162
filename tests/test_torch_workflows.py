"""tests/test_workflows.py's end-to-end workflows (reference lib.zig:1273-1558)
replayed against tpu_knn_torch on the CPU, with the default method (hnsw, as
the tpu_knn test runs them) and with method="seq_search". Workflow 3 (uint8)
is below for hnsw and in tests/test_torch_sift.py
test_3_uint8_vector_workflow_on_the_port for seq_search; workflow 4 is the
string workflow (leven + Int)."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tpu_knn_torch import DataKind, DistKind, Index, Params  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError, SpaceIncompatibleError  # noqa: E402
from tpu_knn_torch.methods.base import Method  # noqa: E402

CPU = {"device": "cpu"}


def _mk(space, params, method, **kw):
    """``method=None``: no method= at all, the API's default (hnsw)."""
    kw = dict(kw, **CPU)
    if method is not None:
        kw["method"] = method
    return Index(space, params, **kw)


def _workflow_1(tmp_path, method):
    idx = _mk("l2", Params(dim=4), method)
    assert idx.get_method() == (method or "hnsw")
    vecs = np.asarray([[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
    idx.add_dense_batch(vecs, ids=[10, 20, 30])
    idx.build_index()
    res = idx.knn_query(vecs[0], 2)
    assert len(res) == 2
    assert res.ids[0] == 10 and res.dists[0] == pytest.approx(0.0, abs=1e-5)
    assert res.ids[1] == 20
    assert idx.get_distance(0, 1) == pytest.approx(math.sqrt(2), rel=1e-4)
    assert np.allclose(idx.get_data_point(1), vecs[1])
    p = str(tmp_path / "dense_idx")
    idx.save(p)
    idx.reset()
    assert idx.data_qty() == 0
    idx2 = Index.load(p, **CPU)
    assert idx2.data_qty() == 3
    assert np.allclose(idx2.get_data_point(2), vecs[2])
    assert idx2.knn_query(vecs[0], 2).ids[0] == 10


def test_1_dense_vector_workflow(tmp_path):
    _workflow_1(tmp_path, 'seq_search')


def test_1_dense_vector_workflow_default_method(tmp_path):
    _workflow_1(tmp_path, None)


def _workflow_2(method):
    """lib.zig:1315 'Index sparse vector workflow'."""
    idx = _mk("cosinesimil_sparse", None, method, data_type=DataKind.SPARSE)
    pts = [
        (np.asarray([1, 3, 5]), np.asarray([1.0, 2.0, 3.0], np.float32)),
        (np.asarray([2, 3]), np.asarray([4.0, 5.0], np.float32)),
    ]
    idx.add_sparse_batch(pts)
    res = idx.knn_query(pts[0], 2)  # auto-build on the first query
    assert res.ids[0] == 1  # default sparse ids are 1-based (lib.zig:748)
    assert res.dists[0] == pytest.approx(0.0, abs=1e-5)
    sp = idx.borrow_data_sparse(1)
    assert np.array_equal(sp.ids, pts[1][0]) and np.allclose(sp.values, pts[1][1])


def test_2_sparse_vector_workflow():
    _workflow_2("seq_search")


def test_2_sparse_vector_workflow_default_method():
    _workflow_2(None)


def test_3_uint8_vector_workflow_default_method():
    descs = np.random.default_rng(2).integers(0, 256, (20, 128)).astype(np.uint8)
    idx = _mk("l2sqr_sift", None, None, data_type=DataKind.UINT8, dist_type=DistKind.INT)
    idx.add_uint8_batch(descs)
    idx.build_index()
    assert idx.get_method() == "hnsw"
    res = idx.knn_query(descs[4], 3)
    assert res.ids[0] == 4 and res.dists[0] == 0
    assert (res.dists == np.rint(res.dists)).all()


def _workflow_4(method):
    """lib.zig:1381 'Index string data workflow' (leven + Int)."""
    idx = _mk("leven", None, method, data_type=DataKind.STRING, dist_type=DistKind.INT)
    idx.add_string_batch(["hello", "help", "world"])
    res = idx.knn_query("hello", 2)
    assert res.ids[0] == 0 and res.dists[0] == 0
    assert res.ids[1] == 1 and res.dists[1] == 2  # hello -> help
    assert idx.borrow_data_point_string(2) == "world"


def test_4_string_workflow():
    _workflow_4("seq_search")


def test_4_string_workflow_default_method():
    _workflow_4(None)


def _workflow_5(method):
    idx = _mk("l2", Params(dim=3), method)
    a, b = [1.0, 2.0, 3.0], [4.0, 6.0, 3.0]
    idx.add_dense_batch(np.asarray([a, b], np.float32))
    manual = math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))
    assert idx.get_distance(0, 1) == pytest.approx(manual, rel=1e-5)


def test_5_get_distance_matches_manual():
    _workflow_5('seq_search')


def test_5_get_distance_matches_manual_default_method():
    _workflow_5(None)


def test_6_range_query_seq_search():
    """The seq_search half: only neighbours inside the radius. A method
    without range search raises SpaceIncompatibleError (the base class's
    default, which HNSW keeps)."""
    x = np.asarray([[0.0, 0.0], [1.0, 0.0], [5.0, 5.0]], np.float32)
    ok = Index("l2", Params(dim=2), method="seq_search", **CPU)
    ok.add_dense_batch(x)
    res = ok.range_query(x[0], 2.0)
    assert set(res.ids) == {0, 1}
    assert (res.dists <= 2.0).all()
    with pytest.raises(SpaceIncompatibleError):
        Method(ok.space).range(x, 2.0)


def test_6_range_query_hnsw_raises():
    """The hnsw half of workflow 6 (reference: hnsw.cc:710-715)."""
    x = np.asarray([[0.0, 0.0], [1.0, 0.0], [5.0, 5.0]], np.float32)
    bad = _mk("l2", Params(dim=2), None)
    bad.add_dense_batch(x)
    with pytest.raises(SpaceIncompatibleError):
        bad.range_query(x[0], 2.0)


def _workflow_7(method):
    v = np.asarray([[3.0, 1.0, 4.0, 1.0, 5.0]], np.float32)
    idx = _mk("l2", Params(dim=5), method)
    idx.add_dense_batch(v)
    assert np.array_equal(idx.borrow_data_dense(0), v[0])


def test_7_borrow_dense_view_equals_original():
    _workflow_7('seq_search')


def test_7_borrow_dense_view_equals_original_default_method():
    _workflow_7(None)


def _workflow_8(method):
    idx = _mk("l2", Params(dim=2), method)
    idx.add_dense_batch(np.zeros((1, 2), np.float32))
    with pytest.raises(InvalidArgumentError):
        idx.get_data_point(5)
    with pytest.raises(InvalidArgumentError):
        idx.get_data_point(-1)


def test_8_get_data_point_invalid_position():
    _workflow_8('seq_search')


def test_8_get_data_point_invalid_position_default_method():
    _workflow_8(None)


def _workflow_9(method):
    idx = _mk("cosine", Params(dim=8), method)
    idx.set_thread_pool_size(4)
    assert idx.get_thread_pool_size() == 4
    with pytest.raises(InvalidArgumentError):
        idx.set_thread_pool_size(-1)
    assert idx.get_space_type() == "cosine"
    assert idx.get_method() == (method or "hnsw")
    assert idx.get_data_type() is DataKind.DENSE
    assert idx.get_dist_type() is DistKind.FLOAT
    assert idx.data_qty() == 0


def test_9_thread_pool_and_metadata():
    _workflow_9('seq_search')


def test_9_thread_pool_and_metadata_default_method():
    _workflow_9(None)


def test_load_data_false_index_only(tmp_path, rng):
    x = rng.standard_normal((64, 8)).astype(np.float32)
    idx = Index("l2", Params(dim=8), method="seq_search", **CPU)
    idx.add_dense_batch(x)
    idx.build_index(Params(chunkSize=16))
    d0, i0 = idx.knn_query_batch(x[:16], 5)
    p = str(tmp_path / "ix")
    idx.save(p, save_data=False)  # one artifact only
    assert not os.path.exists(p + ".dat.npz")
    d1, i1 = Index.load(p, load_data=False, **CPU).knn_query_batch(x[:16], 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-6)
    idx.save(p)
    _, i3 = Index.load(p, load_data=True, **CPU).knn_query_batch(x[:16], 5)
    np.testing.assert_array_equal(i0, i3)


def test_save_v3_single_copy(tmp_path, rng):
    x = rng.standard_normal((48, 8)).astype(np.float32)
    idx = Index("l2", Params(dim=8), method="seq_search", **CPU)
    idx.add_dense_batch(x)
    idx.build_index(Params(chunkSize=16))
    d0, i0 = idx.knn_query_batch(x[:8], 3)
    p = str(tmp_path / "v3")
    idx.save(p)
    assert os.path.exists(p + ".dat.npz")
    with np.load(p + ".idx.npz") as z:
        assert not any(k.startswith("data_") for k in z.files)
    idx_sz = os.path.getsize(p + ".idx.npz")
    for ld in (True, False):
        _, i1 = Index.load(p, load_data=ld, **CPU).knn_query_batch(x[:8], 3)
        np.testing.assert_array_equal(i0, i1)
    p2 = str(tmp_path / "v3b")
    idx.save(p2, save_data=False)
    assert not os.path.exists(p2 + ".dat.npz")
    assert os.path.getsize(p2 + ".idx.npz") > idx_sz


@pytest.mark.parametrize("space", ["l2", "angulardist"])
def test_knn_query_batch_async(space, rng):
    """The future gives what knn_query_batch gives, once and idempotently."""
    x = rng.standard_normal((300, 8)).astype(np.float32)
    idx = Index(space, Params(dim=8), method="seq_search", **CPU)
    idx.add_dense_batch(x)
    fut = idx.knn_query_batch_async(x[:5] + 0.01, 4)
    d, i = fut.result()
    assert fut.result() is fut.result()
    d0, i0 = idx.knn_query_batch(x[:5] + 0.01, 4)
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_array_equal(i, i0)
    assert d.shape == (5, 4)
    with pytest.raises(InvalidArgumentError):
        idx.knn_query_batch_async(x[:1], 0)


def test_async_rints_int_distances():
    descs = np.random.default_rng(8).integers(0, 256, (40, 128)).astype(np.uint8)
    idx = Index("l2sqr_sift", method="seq_search", data_type="dense_uint8_vector", dist_type="int", **CPU)
    idx.add_uint8_batch(descs)
    d, i = idx.knn_query_batch_async(descs[:3], 2).result()
    assert (i[:, 0] == [0, 1, 2]).all() and (d == np.rint(d)).all() and (d[:, 0] == 0).all()
