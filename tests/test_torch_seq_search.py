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
    launches = dict(GM.launches)
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
    tdk, tids, _, _, _ = TSS._knn_device_twopass(ts, ts.encode_queries(q), td, 4, "float32")
    _assert_same_knn(x, q, (np.asarray(jdk), np.asarray(jids)), (tdk.numpy(), tids.numpy()))


def test_pass1_precision_tiers_ported():
    """The reduced tiers run (no longer NotImplementedError); a tier that
    does not exist is still refused at build time."""
    x = clustered(100, DIM, seed=9)
    (tidx,) = _pair(x, {"pass1Precision": "high"})[1:]
    d, i = tidx.knn_query_batch(x[:2], 3)
    assert (i[:, 0] == [0, 1]).all() and tidx.method.last_route == "single"
    idx = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), method="seq_search", device="cpu")
    idx.add_dense_batch(x)
    with pytest.raises(ValueError):
        idx.build_index(tpu_knn_torch.Params(pass1Precision="fp8"))


@pytest.mark.parametrize("route_n,params", [(3000, {}), (5000, {"chunkSize": 1024})])
def test_ids_are_int32_like_tpu_knn(route_n, params):
    """knn_query_batch and knn_query return int32 ids in both packages, on
    both routes (the port used to return int64)."""
    x = clustered(route_n, DIM, seed=10)
    jidx, tidx = _pair(x, params)
    (_, ji), (_, ti) = jidx.knn_query_batch(x[:3], 2), tidx.knn_query_batch(x[:3], 2)
    assert tidx.method.last_route == ("twopass" if params else "single")
    assert ji.dtype == ti.dtype == np.int32
    assert jidx.knn_query(x[0], 2).ids.dtype == tidx.knn_query(x[0], 2).ids.dtype == np.int32


def _encode_pair(x, row_multiple=1024):
    js = tpu_knn.core.registry.create_space("l2", tpu_knn.Params(dim=x.shape[1]))
    st = tpu_knn.core.dataset.DataStore(tpu_knn.DataKind.DENSE)
    st.add_dense_batch(x)
    ts = tpu_knn_torch.core.registry.create_space("l2", tpu_knn_torch.Params(dim=x.shape[1]), device="cpu")
    tst = tpu_knn_torch.core.dataset.DataStore(tpu_knn_torch.DataKind.DENSE)
    tst.add_dense_batch(x)
    return js.encode_dataset(st, row_multiple=row_multiple), ts.encode_dataset(tst, row_multiple=row_multiple)


def test_ensure_cert_metadata_matches_tpu_knn():
    from tpu_knn.spaces.dense import ensure_cert_metadata as jax_meta
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    jd, td = _encode_pair(clustered(3000, DIM, seed=11) * 37.0)
    jax_meta(jd)
    ensure_cert_metadata(td)
    for key in ("max_sq_norm", "max_lo_norm", "max_blo_err"):
        assert td.extra[key].ndim == 0 and td.extra[key].dtype == torch.float32
        np.testing.assert_allclose(float(td.extra[key]), float(jd.extra[key]), rtol=1e-6)
    before = dict(td.extra)
    ensure_cert_metadata(td)  # cached: computed once
    assert all(td.extra[k] is v for k, v in before.items())


@pytest.mark.parametrize("tier", ["high", "bfloat16"])
@pytest.mark.parametrize("with_meta", [True, False])
def test_pass1_eps_is_tpu_knns_plus_the_documented_slack(tier, with_meta):
    """The port's eps equals tpu_knn's plus |scale| * (_acc_slack - D*2^-24)
    * |q| * X_N, and is never below it, with and without the metadata."""
    import jax.numpy as jnp

    from tpu_knn.spaces.dense import ensure_cert_metadata as jax_meta
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    x = clustered(3000, DIM, seed=12) * 37.0
    q = clustered(20, DIM, seed=13) * 37.0
    jd, td = _encode_pair(x)
    if with_meta:
        jax_meta(jd)
        ensure_cert_metadata(td)
    qp = np.zeros((20, 128), np.float32)
    qp[:, :DIM] = q
    jeps = np.asarray(JSS._pass1_eps(jnp.asarray(qp), jd, -2.0, tier), np.float64)
    teps = TSS._pass1_eps(torch.from_numpy(qp), td, -2.0, tier).double().numpy()
    x_n = float(td.extra["max_sq_norm"]) ** 0.5 if with_meta else np.sqrt((x.astype(np.float64) ** 2).sum(1).max())
    extra = 2.0 * (TSS._acc_slack(tier, 128) - 128 * 2.0**-24) * np.linalg.norm(qp, axis=1) * x_n
    np.testing.assert_allclose(teps, jeps + extra, rtol=1e-5)
    assert (teps >= jeps).all() and (extra > 0).all()


def test_acc_slack_counts_the_kernels_truncations():
    u = 2.0**-23 * (1 + 2.0**-5)
    assert TSS._acc_slack("high", 128) == 3 * 8 * 18 * u
    assert TSS._acc_slack("bfloat16", 128) == 8 * 18 * u
    assert TSS._acc_slack("bfloat16", 136) == 9 * 18 * u  # a partial k-step still costs one


def test_certificate_logic():
    """The cases of tests/test_seq_search.py test_certificate_logic."""
    vals = torch.tensor([[1.0, 2.0, 3.0, 10.0]])  # k=2, kg=3 (kg+1 columns)
    assert TSS._certificate_ok(vals, 2, torch.tensor([1.0])).all()  # 10 > 2 + 2*1
    assert not TSS._certificate_ok(vals, 2, torch.tensor([4.0])).all()  # 10 > 2 + 2*4 is False
    vals2 = torch.tensor([[1.0, 2.0, 3.0, 10.0], [1.0, 2.0, 3.0, 4.0]])
    ok = TSS._certificate_ok(vals2, 2, torch.tensor([1.0, 1.0]))
    assert ok.tolist() == [True, False] and not ok.all()  # any row fails the batch


@pytest.mark.parametrize("tier", ["high", "bfloat16"])
def test_reduced_tiers_end_to_end(tier):
    """tests/test_seq_search.py's tier test on both packages: ids equal to
    tpu_knn's (whose CPU path runs f32 pass 1), distances bit-equal to the
    port's f32 tier, with the certificate run and reported."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((13000, 32)).astype(np.float32)
    q = x[:16] + 0.01
    jidx, tidx = _pair(x, {"pass1Precision": tier})
    f32 = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=32), method="seq_search", device="cpu")
    f32.add_dense_batch(x)
    ref, got, base = jidx.knn_query_batch(q, 4), tidx.knn_query_batch(q, 4), f32.knn_query_batch(q, 4)
    assert tidx.method.last_route == "twopass" and "max_lo_norm" in tidx.method.data.extra
    # every query certified: the reduced selection itself drives pass 2
    assert tidx.method.last_certified == 1.0 and tidx.method.last_redone_blocks == 0
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])


@pytest.mark.parametrize("tier,redone", [("high", 1), ("bfloat16", 2)])
def test_reduced_tier_forced_fallback(tier, redone):
    """Row 5 copied into 30 other groups: queries near it cannot be
    certified, so their 256-query block re-runs the f32 pass 1. Under
    "high" the second block certifies and keeps its reduced selection.
    Results stay those of the f32 tier and tpu_knn's up to exact ties."""
    x = clustered(6000, DIM, seed=14)
    for g in range(1, 31):
        x[g * 128 + 7] = x[5]
    q = clustered(300, DIM, seed=15)
    q[10] = x[5] + 0.01
    q[200] = x[5] - 0.01
    jidx, tidx = _pair(x, {"chunkSize": 1024, "pass1Precision": tier})
    f32 = _pair(x, {"chunkSize": 1024})[1]
    ref, got, base = jidx.knn_query_batch(q, 3), tidx.knn_query_batch(q, 3), f32.knn_query_batch(q, 3)
    m = tidx.method
    assert m.last_route == "twopass" and m.last_certified < 1.0 and m.last_redone_blocks == redone
    _assert_same_knn(x, q, ref, got)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])
