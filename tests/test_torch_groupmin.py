"""The port's group-min pass (tpu_knn_torch/ops/groupmin.py) against the
JAX Pallas kernel in interpret mode, on the same numpy inputs. On the CPU
the wrapper runs its plain PyTorch version; the CUDA kernel itself is
held against that version on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tpu_knn.ops.pallas_scan import fused_groupmin as jax_groupmin  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402


def _inputs(qn, n, d=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    qt = (q * q).sum(1).astype(np.float32)
    xt = (x * x).sum(1).astype(np.float32)
    return q, x, qt, xt


def _port(q, x, qt, xt, scale=-2.0, **kw):
    t = [torch.from_numpy(a) for a in (q, x, qt, xt)]
    return GM.fused_groupmin(*t, scale, **kw).numpy()


def _jax(q, x, qt, xt, scale=-2.0, tq=16, tc=256):
    return np.asarray(jax_groupmin(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(qt), jnp.asarray(xt),
        scale=scale, tq=tq, tc=tc, interpret=True,
    ))


def test_groupmin_matches_pallas_interpret():
    # the shapes of tests/test_pallas_kernels.py; atol 1e-3 is the f32
    # summation-order floor of a depth-128 dot of unit normals
    q, x, qt, xt = _inputs(16, 512)
    np.testing.assert_allclose(_port(q, x, qt, xt), _jax(q, x, qt, xt), rtol=1e-5, atol=1e-3)


def test_groupmin_ragged_queries_and_padding_rows():
    """Q=13 needs no padding in the port (the JAX caller pads to 16);
    padding rows carry x_term = 1e30 and stay finite."""
    q, x, qt, xt = _inputs(13, 512, seed=1)
    xt[-200:] = 1e30
    qp = np.concatenate([q, np.zeros((3, 128), np.float32)])
    qtp = np.concatenate([qt, np.zeros(3, np.float32)])
    want = _jax(qp, x, qtp, xt)[:13]
    got = _port(q, x, qt, xt)
    assert got.shape == (13, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chunk_bytes", [16 * 128 * 4, 1 << 28])
def test_groupmin_reference_chunking(chunk_bytes):
    """The plain version's corpus chunking does not change its result."""
    q, x, qt, xt = _inputs(16, 1024, d=16, seed=2)
    t = [torch.from_numpy(a).double() for a in (q, x, qt, xt)]
    got = GM.fused_groupmin_reference(*t, -2.0, chunk_bytes=chunk_bytes).numpy()
    dd = qt[:, None].astype(np.float64) + xt[None, :] - 2.0 * (q.astype(np.float64) @ x.T)
    np.testing.assert_allclose(got, dd.reshape(16, 8, 128).min(2), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize(
    "qn,n,d,exc",
    [(16, 500, 128, ValueError), (16, 512, 12, ValueError), (16, 512, 128, NotImplementedError)],
)
def test_groupmin_contract_raises(qn, n, d, exc):
    """n % 128 != 0 and d % 8 != 0 raise, as on the TPU; so does any
    pass-1 tier but float32, which is the only one ported."""
    q, x, qt, xt = _inputs(qn, n, d=d)
    kw = {"precision": "high"} if exc is NotImplementedError else {}
    with pytest.raises(exc):
        _port(q, x, qt, xt, **kw)


def test_groupmin_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc the build fails loudly and creates nothing."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(GM, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        GM.build()
    assert not (tmp_path / "build").exists()
    assert GM.launches == 0
