"""The exact scan, tpu_knn.Index against tpu_knn_torch.Index(device="cpu")
on the same clustered data, on both routes of SeqSearch._plan_knn, and
the port's scan over a corpus that tpu_knn encoded."""

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
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5  # the l2 norm-identity cancellation floor
DIM = 24


def _pair(x, params=None, ids=None):
    out = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index("l2", pkg.Params(dim=x.shape[1]), method="seq_search", **kw)
        idx.add_dense_batch(x, ids=ids)
        idx.build_index(pkg.Params(params or {}))
        out.append(idx)
    return out


def _assert_same_knn(x, q, ref, got, id_of_pos=None):
    """Distances within tolerance; ids equal except where the two ids are
    tied in exact (f64) distance."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.shape == i2.shape
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    pos = {int(v): p for p, v in enumerate(id_of_pos)} if id_of_pos is not None else None
    for r, c in zip(*np.nonzero(i1 != i2)):
        a, b = (int(i1[r, c]), int(i2[r, c]))
        assert a >= 0 and b >= 0, (r, c, a, b)
        pa, pb = (pos[a], pos[b]) if pos else (a, b)
        da = np.linalg.norm(q[r].astype(np.float64) - x[pa])
        db = np.linalg.norm(q[r].astype(np.float64) - x[pb])
        assert abs(da - db) <= 1e-5 * max(da, db) + 1e-6, (r, c, a, b, da, db)


@pytest.mark.parametrize("k", [1, 3])
def test_twopass_route_matches_tpu_knn(k):
    """n=5000 is not a multiple of 128: chunkSize=1024 pads to 5120."""
    x = clustered(5000, DIM, seed=1)
    q = np.concatenate([x[:5] + 0.01, clustered(8, DIM, seed=2)])  # 13: a ragged bucket
    jidx, tidx = _pair(x, {"chunkSize": 1024})
    launches = GM.launches
    ref, got = jidx.knn_query_batch(q, k), tidx.knn_query_batch(q, k)
    assert jidx.method._plan_knn(k)[1] and tidx.method.last_route == "twopass"
    assert GM.launches == launches  # CPU tensors run the plain version
    _assert_same_knn(x, q, ref, got)
    assert (got[1][:5, 0] == np.arange(5)).all()
    assert tidx.method.dist_comps == 16 * 5000  # the padded bucket of 16


def test_single_pass_route_matches_tpu_knn():
    x = clustered(3000, DIM, seed=3)
    q = clustered(20, DIM, seed=4)
    jidx, tidx = _pair(x)
    ref, got = jidx.knn_query_batch(q, 10), tidx.knn_query_batch(q, 10)
    assert not jidx.method._plan_knn(10)[1] and tidx.method.last_route == "single"
    _assert_same_knn(x, q, ref, got)


def test_k_larger_than_corpus():
    x = clustered(50, DIM, seed=5)
    q = x[:4] + 0.1  # off the corpus: sqrt of a ~0 norm-identity d^2 is noise
    jidx, tidx = _pair(x)
    ref, got = jidx.knn_query_batch(q, 60), tidx.knn_query_batch(q, 60)
    assert got[0].shape == (4, 60)
    assert (got[1][:, 50:] == -1).all() and np.isinf(got[0][:, 50:]).all()
    _assert_same_knn(x, q, ref, got)
    res = tidx.knn_query(x[0], 60)
    assert len(res) == 50 and res.ids[0] == 0


def test_custom_ids():
    x = clustered(8000, DIM, seed=6)
    ids = np.arange(8000) * 7 + 3
    jidx, tidx = _pair(x, {"chunkSize": 256}, ids=ids)
    q = x[10:18] + 0.01
    ref, got = jidx.knn_query_batch(q, 5), tidx.knn_query_batch(q, 5)
    assert tidx.method.last_route == "twopass"
    _assert_same_knn(x, q, ref, got, id_of_pos=ids)
    assert (got[1][:, 0] == ids[10:18]).all()


def test_twopass_on_corpus_encoded_by_tpu_knn():
    """State carried across: tpu_knn encodes, the port scans."""
    x = clustered(4000, DIM, seed=7)
    q = clustered(16, DIM, seed=8)
    js = tpu_knn.core.registry.create_space("l2", tpu_knn.Params(dim=DIM))
    st = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.DENSE)
    st.add_dense_batch(x)
    jd = js.encode_dataset(st, row_multiple=1024)
    jq = js.encode_queries(q)
    jdk, jids, _, _ = JSS._knn_device_twopass(js, jq, jd, 4, 1024, "float32")

    ts = tpu_knn_torch.core.registry.create_space("l2", tpu_knn_torch.Params(dim=DIM), device="cpu")
    td = dense_data_from_numpy(
        np.asarray(jd.vecs), np.asarray(jd.ids), jd.count, jd.dim,
        np.asarray(jd.row_term), np.asarray(jd.extra["pad"]), "cpu",
    )
    tdk, tids, _ = TSS._knn_device_twopass(ts, ts.encode_queries(q), td, 4, "float32")
    _assert_same_knn(x, q, (np.asarray(jdk), np.asarray(jids)), (tdk.numpy(), tids.numpy()))


def test_pass1_precision_tiers_not_ported():
    x = clustered(100, DIM, seed=9)
    (tidx,) = _pair(x, {"pass1Precision": "high"})[1:]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tidx.knn_query_batch(x[:2], 3)
    idx = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), method="seq_search", device="cpu")
    idx.add_dense_batch(x)
    with pytest.raises(ValueError):
        idx.build_index(tpu_knn_torch.Params(pass1Precision="fp8"))
