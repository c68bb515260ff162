"""The port's dense spaces (l2 and the scalar-product family), distance and
top-k primitives, and synthetic data against tpu_knn on the same numpy
inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_knn.core.dataset import DataKind as JDataKind, DataStore as JDataStore  # noqa: E402
from tpu_knn.core.registry import create_space as jax_create_space  # noqa: E402
from tpu_knn.eval import datasets as jds  # noqa: E402
from tpu_knn.ops import distance as JD  # noqa: E402
from tpu_knn.ops import topk as JT  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn_torch.core.registry import create_space  # noqa: E402
from tpu_knn_torch.eval import datasets as tds  # noqa: E402
from tpu_knn_torch.ops import distance as TD  # noqa: E402
from tpu_knn_torch.ops import topk as TT  # noqa: E402
from tpu_knn_torch.spaces.dense import PAD_TERM  # noqa: E402

# l2 distances compared across code paths: the norm-identity cancellation floor
RTOL, ATOL = 5e-3, 1e-5


def _encode_both(x, row_multiple):
    js = jax_create_space("l2", {"dim": x.shape[1]})
    jst = JDataStore(JDataKind.DENSE)
    jst.add_dense_batch(x)
    ts = create_space("l2", {"dim": x.shape[1]}, device="cpu")
    tst = DataStore(DataKind.DENSE)
    tst.add_dense_batch(x)
    jd = js.encode_dataset(jst, row_multiple=row_multiple)
    return js, jd, ts, ts.encode_dataset(tst, row_multiple=row_multiple)


def test_l2_encode_and_block_match_tpu_knn():
    x = tds.clustered(300, 20, seed=3)
    q = tds.clustered(17, 20, seed=4)
    js, jd, ts, td = _encode_both(x, row_multiple=128)
    np.testing.assert_array_equal(td.vecs.numpy(), np.asarray(jd.vecs))
    np.testing.assert_array_equal(td.ids.numpy(), np.asarray(jd.ids))
    np.testing.assert_array_equal(td.extra["pad"].numpy(), np.asarray(jd.extra["pad"]))
    np.testing.assert_allclose(td.row_term.numpy(), np.asarray(jd.row_term), rtol=RTOL, atol=ATOL)
    assert (td.count, td.dim) == (jd.count, jd.dim)

    jq, tq = js.encode_queries(q), ts.encode_queries(q)
    assert sorted(jq) == sorted(tq)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_allclose(tq["q_term"].numpy(), np.asarray(jq["q_term"]), rtol=RTOL, atol=ATOL)

    n_pad = td.ids.shape[0]
    jb = np.asarray(js.block(jq, js.slice_data(jd, 0, n_pad)))
    tb = ts.block(tq, ts.slice_data(td, 0, n_pad)).numpy()
    np.testing.assert_allclose(tb[:, :300], jb[:, :300], rtol=RTOL, atol=ATOL)
    assert (tb[:, 300:] >= 1e29).all() and (jb[:, 300:] >= 1e29).all()
    assert ts.pass1_affine() == js.pass1_affine()


def test_l2_padding_rows():
    x = tds.clustered(10, 8, seed=0)
    _, _, ts, td = _encode_both(x, row_multiple=16)
    assert td.vecs.shape == (16, 128) and td.vecs.dtype == torch.float32
    assert (td.ids[10:] == -1).all() and (td.ids[:10] == torch.arange(10)).all()
    assert (td.extra["pad"][10:] == PAD_TERM).all() and (td.extra["pad"][:10] == 0).all()
    assert (td.vecs[10:] == 0).all()


def test_pairwise_matches_tpu_knn():
    a, b = tds.clustered(2, 12, seed=5)
    js = jax_create_space("l2", {"dim": 12})
    ts = create_space("l2", {"dim": 12})
    assert ts.pairwise(a, b) == pytest.approx(js.pairwise(a, b), rel=RTOL, abs=ATOL)
    assert ts.pairwise(a, b) == pytest.approx(float(np.linalg.norm(a - b)), rel=RTOL)


def test_distance_primitives_match_tpu_knn():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    rows = rng.standard_normal((5, 7, 32)).astype(np.float32)
    tq, tx, tr = (torch.from_numpy(a) for a in (q, x, rows))
    np.testing.assert_allclose(TD.matmul(tq, tx).numpy(), np.asarray(JD.matmul(q, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TD.factored(tq, tx, TD.sq_norms(tq), TD.sq_norms(tx), scale=-2.0).numpy(),
        np.asarray(JD.factored(q, x, JD.sq_norms(q), JD.sq_norms(x), scale=-2.0)),
        rtol=RTOL, atol=1e-4,
    )
    np.testing.assert_allclose(TD.batched_dot(tq, tr).numpy(), np.asarray(JD.batched_dot(q, rows)),
                               rtol=1e-5, atol=1e-5)
    # the bfloat16 tier: bf16-rounded operands, exact products, f32 sums in
    # both packages, so only the summation order differs
    np.testing.assert_allclose(TD.matmul(tq, tx, precision="bfloat16").numpy(),
                               np.asarray(JD.matmul(q, x, precision="bfloat16")), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown precision"):
        TD.matmul(tq, tx, precision="fp8")


def test_smallest_k_breaks_ties_by_lowest_index():
    """Heavily tied rows: values, order and columns equal lax.top_k's."""
    rng = np.random.default_rng(7)
    d = rng.integers(0, 4, size=(6, 50)).astype(np.float32)
    d[0] = 1.0  # one row all tied
    for k in (1, 5, 20, 50):
        jv, ji = JT.smallest_k(jnp.asarray(d), k)
        tv, ti = TT.smallest_k(torch.from_numpy(d), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    idx = rng.permutation(50).astype(np.int64)
    jv, ji = JT.smallest_k(jnp.asarray(d), 7, jnp.asarray(idx))
    tv, ti = TT.smallest_k(torch.from_numpy(d), 7, torch.from_numpy(idx))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_streaming_smallest_k_matches_tpu_knn():
    """Chunked merge with ties across chunks keeps the lowest column."""
    rng = np.random.default_rng(8)
    full = rng.integers(0, 6, size=(4, 96)).astype(np.float32)
    full[:, 90:] = np.inf  # padding columns
    chunk = 32

    jv, ji = JT.streaming_smallest_k(
        lambda ci: jax.lax.dynamic_slice_in_dim(jnp.asarray(full), ci * chunk, chunk, 1), 3, chunk, 4, 10
    )
    tv, ti = TT.streaming_smallest_k(
        lambda ci: torch.from_numpy(full[:, ci * chunk:(ci + 1) * chunk]), 3, chunk, 4, 10
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    mv, mi = TT.merge_topk(tv[:, :3], ti[:, :3], tv[:, 3:], ti[:, 3:], 4)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji)[:, :4])


@pytest.mark.parametrize("gen", ["clustered", "sift_like"])
def test_datasets_bit_identical(gen, tmp_path, monkeypatch):
    monkeypatch.setattr(jds, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tds, "_CACHE_DIR", str(tmp_path / "torch"))
    if gen == "clustered":
        a, b = jds.clustered(500, 24, seed=11), tds.clustered(500, 24, seed=11)
    else:
        a, b = jds.sift_like(700, 16, seed=12), tds.sift_like(700, 16, seed=12)
        # the second call reads the cache and returns the same bits
        np.testing.assert_array_equal(tds.sift_like(700, 16, seed=12), b)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_matmul_precision_tiers():
    """"high" is tpu_knn's bf16x3 (hi.hi + hi.lo + lo.hi) and "bfloat16"
    the product of the bf16-rounded operands, both summed in f32: each
    within f32 summation noise of its float64 formula, and within the
    tier's error bound of the exact product."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((6, 40)).astype(np.float32)
    x = rng.standard_normal((30, 40)).astype(np.float32)
    qh, xh = _bf16(q), _bf16(x)
    ql, xl = _bf16(q - qh), _bf16(x - xh)
    f64 = np.float64
    want = {
        "high": qh.astype(f64) @ xh.T + (qh.astype(f64) @ xl.T + ql.astype(f64) @ xh.T),
        "bfloat16": qh.astype(f64) @ xh.T,
    }
    exact = q.astype(f64) @ x.T.astype(f64)
    scale = np.abs(q).astype(f64) @ np.abs(x).T
    for tier, rel in (("high", 2.0**-15), ("bfloat16", 2.0**-7)):
        got = TD.matmul(torch.from_numpy(q), torch.from_numpy(x), precision=tier)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[tier], rtol=0, atol=1e-5)
        assert (np.abs(got.numpy() - exact) <= rel * scale + 1e-6).all()


SCALAR = ["cosinesimil", "angulardist", "negdotprod"]


def _encode_space(name, x, row_multiple=128):
    js = jax_create_space(name, {"dim": x.shape[1]})
    jst = JDataStore(JDataKind.DENSE)
    jst.add_dense_batch(x)
    ts = create_space(name, {"dim": x.shape[1]}, device="cpu")
    tst = DataStore(DataKind.DENSE)
    tst.add_dense_batch(x)
    return js, js.encode_dataset(jst, row_multiple=row_multiple), ts, ts.encode_dataset(tst, row_multiple=row_multiple)


@pytest.mark.parametrize("name", SCALAR)
def test_scalar_space_encode_bit_equal_to_tpu_knn(name):
    """Host-side normalization as tpu_knn's: bit-equal corpus and query
    encodes, zero rows included (they stay zero)."""
    x = tds.clustered(300, 20, seed=13) * 3.0
    x[7] = 0.0
    q = tds.clustered(9, 20, seed=14)
    q[2] = 0.0
    js, jd, ts, td = _encode_space(name, x)
    np.testing.assert_array_equal(td.vecs.numpy(), np.asarray(jd.vecs))
    np.testing.assert_array_equal(td.ids.numpy(), np.asarray(jd.ids))
    np.testing.assert_array_equal(td.extra["pad"].numpy(), np.asarray(jd.extra["pad"]))
    assert td.row_term is None and jd.row_term is None
    assert (td.vecs[7] == 0).all()
    jq, tq = js.encode_queries(q), ts.encode_queries(q)
    assert sorted(jq) == sorted(tq) == ["q"]
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    assert (tq["q"][2] == 0).all()
    if name != "negdotprod":
        norms = np.linalg.norm(td.vecs.numpy()[:300], axis=1)
        np.testing.assert_allclose(np.delete(norms, 7), 1.0, rtol=1e-6)
    assert ts.pass1_affine() == js.pass1_affine() == (-1.0, 0.0, 0.0)
    r = ts.rows_as_queries(td.vecs[:5])
    assert set(r) == {"q"} and torch.equal(r["q"], td.vecs[:5])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SCALAR)
def test_scalar_space_block_matches_tpu_knn(name, precision):
    x = tds.clustered(300, 20, seed=15)
    q = tds.clustered(11, 20, seed=16)
    js, jd, ts, td = _encode_space(name, x)
    jq, tq = js.encode_queries(q), ts.encode_queries(q)
    jb = np.asarray(js.block(jq, js.slice_data(jd, 0, 384), precision))
    tb = ts.block(tq, ts.slice_data(td, 0, 384), precision).numpy()
    np.testing.assert_allclose(tb[:, :300], jb[:, :300], rtol=RTOL, atol=1e-5)
    assert (tb[:, 300:] >= 1e29).all() and (jb[:, 300:] >= 1e29).all()
    if precision != "float32":
        return
    # pass 2's affine form + pass1_post gives the block's distances
    g = tq["q"].double() @ td.vecs[:300].double().T
    s = (-g).float()
    np.testing.assert_allclose(ts.pass1_post(s, tq).numpy(), tb[:, :300], rtol=1e-5, atol=1e-5)


def test_scalar_blocked_families_match_tpu_knn():
    rng = np.random.default_rng(17)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    x = rng.standard_normal((23, 16)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    xn[0] = qn[0]  # a cosine at 1: the clip keeps arccos finite
    t = torch.from_numpy
    for tf, jf, a, b in (
        (TD.l2_blocked, JD.l2_blocked, q, x),
        (TD.cosine_blocked, JD.cosine_blocked, qn, xn),
        (TD.angular_blocked, JD.angular_blocked, qn, xn),
        (TD.negdot_blocked, JD.negdot_blocked, q, x),
    ):
        got, want = tf(t(a), t(b)).numpy(), np.asarray(jf(a, b))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3 if tf is TD.angular_blocked else 1e-5)


def test_cosine_alias_and_space_type():
    import tpu_knn
    import tpu_knn_torch

    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index("cosine", pkg.Params(dim=4), method="seq_search", **kw)
        assert idx.space_name == "cosinesimil" and idx.get_space_type() == "cosine"
        assert type(idx.space).__name__ == "CosineSpace"
        assert pkg.Index("angulardist", pkg.Params(dim=4), method="seq_search", **kw).get_space_type() == "angulardist"
