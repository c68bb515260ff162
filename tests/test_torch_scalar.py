"""The scalar-product spaces (cosinesimil, angulardist, negdotprod) through
tpu_knn.Index and tpu_knn_torch.Index(device="cpu") on the same clustered
data: both routes of SeqSearch._plan_knn, the reduced pass-1 tiers, and a
corpus that tpu_knn encoded, scanned by the port."""

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

RTOL, ATOL = 5e-3, 1e-5
DIM = 24
SCALAR = ["cosinesimil", "angulardist", "negdotprod"]


def exact_dists(space, q, x):
    """Float64 distances [Q, N] of ``space`` on raw rows."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    if space == "negdotprod":
        return -(q @ x.T)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-300)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-300)
    cos = np.clip(qn @ xn.T, -1.0, 1.0)
    return 1.0 - cos if space == "cosinesimil" else np.arccos(cos)


def assert_same_knn(space, x, q, ref, got, rel=1e-5):
    """Distances within tolerance; ids equal except where the two ids'
    exact (f64) distances tie within ``rel``."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.shape == i2.shape
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    ex = exact_dists(space, q, x)
    for r, c in zip(*np.nonzero(i1 != i2)):
        a, b = int(i1[r, c]), int(i2[r, c])
        assert a >= 0 and b >= 0, (r, c, a, b)
        da, db = ex[r, a], ex[r, b]
        assert abs(da - db) <= rel * max(abs(da), abs(db)) + 1e-6, (r, c, a, b, da, db)


def pair(space, x, params=None):
    out = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method="seq_search", **kw)
        idx.add_dense_batch(x)
        idx.build_index(pkg.Params(params or {}))
        out.append(idx)
    return out


def _queries(x, seed):
    # near-duplicates of corpus rows (arccos is flat near 1, so off by 0.01)
    # and fresh points: 13 queries, a ragged bucket of 16
    return np.concatenate([x[:5] + 0.01, clustered(8, DIM, seed=seed)])


@pytest.mark.parametrize("space", SCALAR)
def test_twopass_route_matches_tpu_knn(space):
    """n=5000 (not a multiple of 128) padded to 5120 by chunkSize=1024; pass
    1 runs the group-min kernel's plain version with scale -1 and no terms."""
    x = clustered(5000, DIM, seed=21)
    q = _queries(x, 22)
    jidx, tidx = pair(space, x, {"chunkSize": 1024})
    launches = dict(GM.launches)
    ref, got = jidx.knn_query_batch(q, 3), tidx.knn_query_batch(q, 3)
    assert jidx.method._plan_knn(3)[1] and tidx.method.last_route == "twopass"
    assert GM.launches == launches  # CPU tensors run the plain version
    assert_same_knn(space, x, q, ref, got)
    if space != "negdotprod":
        assert (got[1][:5, 0] == np.arange(5)).all()
    assert got[1].dtype == np.int32 and tidx.method.dist_comps == 16 * 5000


@pytest.mark.parametrize("space", SCALAR)
def test_single_pass_route_matches_tpu_knn(space):
    x = clustered(3000, DIM, seed=23)
    q = _queries(x, 24)
    jidx, tidx = pair(space, x)
    ref, got = jidx.knn_query_batch(q, 10), tidx.knn_query_batch(q, 10)
    assert not jidx.method._plan_knn(10)[1] and tidx.method.last_route == "single"
    assert_same_knn(space, x, q, ref, got)


@pytest.mark.parametrize("tier", ["high", "bfloat16"])
@pytest.mark.parametrize("space", ["cosinesimil", "angulardist"])
def test_reduced_tiers_bit_identical_to_f32(space, tier):
    """The certificate runs on the normalized rows; pass 2 re-scores in f32,
    so results equal the f32 tier's bit for bit and tpu_knn's ids."""
    x = clustered(13000, 32, seed=25)
    q = x[:16] + 0.01
    jidx, tidx = pair(space, x, {"pass1Precision": tier})
    f32 = pair(space, x)[1]
    ref, got, base = jidx.knn_query_batch(q, 4), tidx.knn_query_batch(q, 4), f32.knn_query_batch(q, 4)
    m = tidx.method
    assert m.last_route == "twopass" and "max_lo_norm" in m.data.extra
    # the metadata is that of the normalized rows: every row norm is 1
    assert float(m.data.extra["max_sq_norm"]) == pytest.approx(1.01, rel=1e-5)
    assert 0.0 < m.last_certified <= 1.0
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])
    assert_same_knn(space, x, q, ref, got)


@pytest.mark.parametrize("space", SCALAR)
def test_corpus_encoded_by_tpu_knn(space):
    """State carried across: tpu_knn encodes (normalizes), the port scans."""
    x, q = clustered(4000, DIM, seed=26), clustered(16, DIM, seed=27)
    js = tpu_knn.core.registry.create_space(space, tpu_knn.Params(dim=DIM))
    st = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.DENSE)
    st.add_dense_batch(x)
    jd = js.encode_dataset(st, row_multiple=1024)
    jdk, jids, _, _ = JSS._knn_device_twopass(js, js.encode_queries(q), jd, 4, 1024, "float32")
    ts = tpu_knn_torch.core.registry.create_space(space, tpu_knn_torch.Params(dim=DIM), device="cpu")
    td = dense_data_from_numpy(
        np.asarray(jd.vecs), np.asarray(jd.ids), jd.count, jd.dim, None,
        np.asarray(jd.extra["pad"]), "cpu",
    )
    tdk, tids, _, _, _ = TSS._knn_device_twopass(ts, ts.encode_queries(q), td, 4, 1024, "float32")
    assert_same_knn(space, x, q, (np.asarray(jdk), np.asarray(jids)), (tdk.numpy(), tids.numpy()))


def test_kernel_inputs_of_the_scalar_spaces():
    """scale -1, a zero q_term and x_term = the padding mask alone."""
    x = clustered(300, DIM, seed=28)
    for space in SCALAR:
        tidx = pair(space, x)[1]
        data = tidx.method.data
        qenc = tidx.space.encode_queries(x[:3])
        q, qt, xt, scale = TSS._kernel_inputs(tidx.space, qenc, data)
        assert scale == -1.0 and q is qenc["q"]
        assert torch.equal(qt, torch.zeros(3)) and xt is data.extra["pad"]
