"""The port's l2sqr_sift space (uint8 SIFT descriptors, exact integer L2^2,
the int8 pass-1 tier) against tpu_knn on the same numpy inputs, and state
carried across from a corpus that tpu_knn encoded."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.methods import seq_search as JSS  # noqa: E402
from tpu_knn_torch.core.dataset import dense_data_from_numpy  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402
from tpu_knn_torch.methods import seq_search as TSS  # noqa: E402

SIFT = dict(method="seq_search", data_type="dense_uint8_vector", dist_type="int")


def _u8(n, seed):
    """Clustered uint8[128] descriptors centred on 128, so the all-128
    padding rows (int8 zeros) lie among the near neighbours and must be
    masked."""
    return np.clip(np.rint(clustered(n, 128, seed=seed) * 40.0 + 128.0), 0, 255).astype(np.uint8)


def _exact(q, x):
    return ((q[:, None, :].astype(np.int64) - x[None, :, :].astype(np.int64)) ** 2).sum(-1)


def _pair(x, params=None):
    out = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index("l2sqr_sift", **SIFT, **kw)
        idx.add_uint8_batch(x)
        idx.build_index(pkg.Params(params or {}))
        out.append(idx)
    return out


def _assert_same_int_knn(x, q, ref, got):
    """Distances exactly equal; ids equal except among exactly equal distances."""
    (d1, i1), (d2, i2) = ref, got
    np.testing.assert_array_equal(d2, d1)
    ex = _exact(q, x)
    rows = np.arange(len(q))[:, None]
    np.testing.assert_array_equal(ex[rows, i2], d2)  # each id's exact distance is the one returned
    assert all(len(set(r)) == len(r) for r in i2.tolist())
    diff = i1 != i2
    np.testing.assert_array_equal(ex[rows, i1][diff], ex[rows, i2][diff])


def _spaces():
    js = tpu_knn.core.registry.create_space("l2sqr_sift", None)
    ts = tpu_knn_torch.core.registry.create_space("l2sqr_sift", None, device="cpu")
    return js, ts


def _stores(x):
    jst = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.UINT8)
    tst = tpu_knn_torch.core.dataset.DataStore(tpu_knn_torch.DataKind.UINT8)
    jst.add_uint8_batch(x)
    tst.add_uint8_batch(x)
    return jst, tst


def test_sift_encode_and_block_bit_equal_to_tpu_knn():
    x, q = _u8(300, seed=1), _u8(17, seed=2)
    js, ts = _spaces()
    jst, tst = _stores(x)
    jd, td = js.encode_dataset(jst, row_multiple=128), ts.encode_dataset(tst, row_multiple=128)
    assert td.vecs.dtype == torch.int8 and (td.count, td.dim) == (jd.count, jd.dim) == (300, 128)
    np.testing.assert_array_equal(td.vecs.numpy(), np.asarray(jd.vecs))
    np.testing.assert_array_equal(td.row_term.numpy(), np.asarray(jd.row_term))
    np.testing.assert_array_equal(td.extra["pad"].numpy(), np.asarray(jd.extra["pad"]))
    np.testing.assert_array_equal(td.ids.numpy(), np.asarray(jd.ids))
    # the term is a function of the stored row, bit for bit
    np.testing.assert_array_equal(ts.term_from_rows(td.vecs).numpy()[:300], td.row_term.numpy()[:300])
    jq, tq = js.encode_queries(q), ts.encode_queries(q)
    assert set(tq) == set(jq) and tq["_dimconst"].ndim == 0
    for key in jq:
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    jb = np.asarray(js.block(jq, js.slice_data(jd, 0, 384)))
    tb = ts.block(tq, ts.slice_data(td, 0, 384)).numpy()
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tb[:, :300], _exact(q, x).astype(np.float32))


@pytest.mark.parametrize("n,params,route", [(3000, {}, "single"), (5000, {"chunkSize": 1024}, "twopass")])
def test_sift_index_matches_tpu_knn(n, params, route):
    x = _u8(n, seed=3)
    q = np.concatenate([x[:5], _u8(8, seed=4)])  # 13: a ragged bucket
    jidx, tidx = _pair(x, params)
    ref, got = jidx.knn_query_batch(q, 3), tidx.knn_query_batch(q, 3)
    assert tidx.method.last_route == route
    assert got[1].dtype == ref[1].dtype == np.int32
    _assert_same_int_knn(x, q, ref, got)
    assert (got[0][:5, 0] == 0).all()
    res = tidx.knn_query(q[6], 3)  # a non-dense point goes in as a one-element list
    np.testing.assert_array_equal(res.dists, got[0][6])


def test_sift_get_distance():
    x = _u8(50, seed=5)
    jidx, tidx = _pair(x)
    want = int(_exact(x[3:4], x[17:18])[0, 0])
    assert tidx.get_distance(3, 17) == jidx.get_distance(3, 17) == want
    assert isinstance(tidx.get_distance(3, 17), int)


def test_3_uint8_vector_workflow_on_the_port():
    """tests/test_workflows.py test_3_uint8_vector_workflow with seq_search."""
    rng = np.random.default_rng(7)
    descs = rng.integers(0, 256, size=(2, 128)).astype(np.uint8)
    idx = tpu_knn_torch.Index(
        "l2sqr_sift",
        method="seq_search",
        data_type=tpu_knn_torch.DataKind.UINT8,
        dist_type=tpu_knn_torch.DistKind.INT,
        device="cpu",
    )
    idx.add_uint8_batch(descs)
    res = idx.knn_query(descs[0], 2)
    assert len(res) == 2
    assert res.ids[0] == 0 and res.dists[0] == 0  # exact integer distance
    want = int(np.sum((descs[0].astype(np.int64) - descs[1].astype(np.int64)) ** 2))
    assert int(res.dists[1]) == want


def test_sift_corpus_encoded_by_tpu_knn():
    """An int8 corpus tpu_knn encoded, carried over with
    dense_data_from_numpy (vecs stay int8) and scanned by the port."""
    x, q = _u8(4000, seed=8), _u8(16, seed=9)
    js, ts = _spaces()
    jst, _ = _stores(x)
    jd = js.encode_dataset(jst, row_multiple=1024)
    jdk, jids, _, _ = JSS._knn_device_twopass(js, js.encode_queries(q), jd, 5, 1024, "float32")
    td = dense_data_from_numpy(
        np.asarray(jd.vecs), np.asarray(jd.ids), jd.count, jd.dim,
        np.asarray(jd.row_term), np.asarray(jd.extra["pad"]), "cpu",
    )
    assert td.vecs.dtype == torch.int8
    tdk, tids, _, ok, redone = TSS._knn_device_twopass(ts, ts.encode_queries(q), td, 5, 1024, "float32", "high")
    assert (ok, redone) == (1.0, 0)  # int8 pass 1 is exact: no certificate
    _assert_same_int_knn(x, q, (np.asarray(jdk), np.asarray(jids)), (tdk.numpy(), tids.numpy()))


def test_sift_dimconst_survives_pass2_blocks(monkeypatch):
    """The 0-d _dimconst goes whole to every pass-2 query block."""
    x, q = _u8(5000, seed=10), _u8(10, seed=11)
    _, tidx = _pair(x, {"chunkSize": 1024})
    want = tidx.knn_query_batch(q, 3)
    monkeypatch.setattr(TSS, "_PASS2_QBLK", 4)  # 16 bucketed queries: 4 blocks
    got = tidx.knn_query_batch(q, 3)
    assert tidx.method.last_route == "twopass"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_dense_data_from_numpy_carries_cert_metadata():
    """The 0-d certificate metadata of a tpu_knn-encoded f32 corpus crosses
    over, and the port's reduced tier scans it as tpu_knn's f32 path does."""
    from tpu_knn.spaces.dense import ensure_cert_metadata as jax_meta

    x, q = clustered(4000, 24, seed=12), clustered(16, 24, seed=13)
    js = tpu_knn.core.registry.create_space("l2", tpu_knn.Params(dim=24))
    st = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.DENSE)
    st.add_dense_batch(x)
    jd = js.encode_dataset(st, row_multiple=1024)
    jax_meta(jd)
    jdk, jids, _, _ = JSS._knn_device_twopass(js, js.encode_queries(q), jd, 4, 1024, "float32")
    td = dense_data_from_numpy(
        np.asarray(jd.vecs), np.asarray(jd.ids), jd.count, jd.dim,
        np.asarray(jd.row_term), np.asarray(jd.extra["pad"]), "cpu",
        extra={k: np.asarray(v) for k, v in jd.extra.items()},
    )
    assert td.vecs.dtype == torch.float32 and set(td.extra) == set(jd.extra)
    for key in ("max_sq_norm", "max_lo_norm", "max_blo_err"):
        assert td.extra[key].ndim == 0 and float(td.extra[key]) == float(jd.extra[key])
    ts = tpu_knn_torch.core.registry.create_space("l2", tpu_knn_torch.Params(dim=24), device="cpu")
    tdk, tids, _, ok, _ = TSS._knn_device_twopass(ts, ts.encode_queries(q), td, 4, 1024, "float32", "high")
    assert 0.0 < float(ok) <= 1.0
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tdk.numpy(), np.asarray(jdk), rtol=5e-3, atol=1e-5)
