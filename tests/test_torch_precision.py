"""SeqSearch's ``precision`` index parameter (the matmul tier of
``space.block``) against tpu_knn: the single-pass scan and range search
run it; on the two-pass route pass 2 is f32, so every precision gives the
f32 tier's bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402

DIM = 24


def _index(pkg, x, params, space="l2", **kw):
    idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method="seq_search", **kw)
    idx.add_dense_batch(x)
    idx.build_index(pkg.Params(params))
    return idx


def _port(x, params, space="l2"):
    return _index(tpu_knn_torch, x, params, space, device="cpu")


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
@pytest.mark.parametrize("space", ["l2", "cosinesimil"])
def test_twopass_route_ignores_precision(space, precision):
    """Results bit-identical to float32's; tpu_knn returns the same ids."""
    x = clustered(5000, DIM, seed=31)
    q = clustered(13, DIM, seed=32)
    got = _port(x, {"chunkSize": 1024, "precision": precision}, space)
    base = _port(x, {"chunkSize": 1024}, space)
    d, i = got.knn_query_batch(q, 3)
    d0, i0 = base.knn_query_batch(q, 3)
    assert got.method.last_route == "twopass"
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_array_equal(i, i0)
    jd, ji = _index(tpu_knn, x, {"chunkSize": 1024, "precision": precision}, space).knn_query_batch(q, 3)
    np.testing.assert_array_equal(ji, i)
    np.testing.assert_allclose(d, jd, rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_single_pass_precision_matches_tpu_knn(precision):
    """The single-pass scan runs space.block at ``precision`` in both
    packages. tpu_knn on the CPU computes "bfloat16" as the port does and
    "high" in f32 (the CPU backend ignores Precision.HIGH), so ids agree
    except where two ids' exact distances lie within the tier's error."""
    x = clustered(3000, DIM, seed=33)
    q = clustered(20, DIM, seed=34)
    tidx = _port(x, {"precision": precision})
    jidx = _index(tpu_knn, x, {"precision": precision})
    (jd, ji), (td, ti) = jidx.knn_query_batch(q, 10), tidx.knn_query_batch(q, 10)
    assert tidx.method.last_route == "single"
    rel = 2.0**-7 if precision == "bfloat16" else 1e-3
    np.testing.assert_allclose(td, jd, rtol=rel, atol=1e-5)
    ex = np.linalg.norm(q[:, None, :].astype(np.float64) - x[None], axis=-1)
    for r, c in zip(*np.nonzero(ji != ti)):
        da, db = ex[r, ji[r, c]], ex[r, ti[r, c]]
        assert abs(da - db) <= rel * max(da, db), (r, c, da, db)
    # the tier really ran: bfloat16 distances are not the f32 ones
    f32 = _port(x, {}).knn_query_batch(q, 10)[0]
    assert precision == "high" or not np.array_equal(td, f32)


def test_range_runs_precision():
    """Range search scores with space.block at ``precision`` too."""
    x = clustered(3000, DIM, seed=35)
    q = clustered(8, DIM, seed=36)
    r = float(np.median(_port(x, {}).knn_query_batch(q, 20)[0][:, -1]))
    for precision, rel in (("high", 1e-3), ("bfloat16", 2.0**-7)):
        got = _port(x, {"precision": precision}).range_query_batch(q, r)
        ref = _index(tpu_knn, x, {"precision": precision}).range_query_batch(q, r)
        assert sum(len(g) for g in got) > 0
        for j, (g, w) in enumerate(zip(got, ref)):
            assert (g.dists <= r).all() and (np.diff(g.dists) >= 0).all()
            # membership may differ only for points within the tier's error of r
            ex = np.linalg.norm(x[np.setxor1d(g.ids, w.ids)].astype(np.float64) - q[j], axis=1)
            assert (np.abs(ex - r) <= rel * r).all(), (precision, j, ex, r)


def test_unknown_precision_raises_value_error():
    x = clustered(300, DIM, seed=37)
    idx = _port(x, {"precision": "fp8"})
    with pytest.raises(ValueError, match="unknown precision"):
        idx.knn_query_batch(x[:2], 3)
