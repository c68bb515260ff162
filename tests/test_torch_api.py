"""Error and API parity of tpu_knn_torch.Index with tpu_knn.Index on the
inputs of tests/test_edge_cases.py, plus the port's own device rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.core import errors as JE, params as JP, registry as JR  # noqa: E402
from tpu_knn_torch.core import errors as TE, params as TP, registry as TR  # noqa: E402

PKGS = [(tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})]


def _index(pkg, kw, space="l2", dim=4, method="seq_search"):
    params = pkg.Params(dim=dim) if dim is not None else None
    return pkg.Index(space, params, method=method, **kw)


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, info.value


def _both(make_and_fail):
    """Run the same failing scenario on both packages; return the two exceptions."""
    (jn, je), (tn, te) = (_raised(lambda p=p, kw=kw: make_and_fail(p, kw)) for p, kw in PKGS)
    assert jn == tn, (jn, tn)
    return je, te


def _k_zero(pkg, kw):
    idx = _index(pkg, kw)
    idx.add_dense_batch(np.zeros((3, 4), np.float32))
    idx.knn_query(np.zeros(4, np.float32), 0)


def _k_zero_batch(pkg, kw):
    idx = _index(pkg, kw)
    idx.add_dense_batch(np.zeros((3, 4), np.float32))
    idx.knn_query_batch(np.zeros((2, 4), np.float32), -1)


def _dim_mismatch(pkg, kw):
    _index(pkg, kw).add_dense_batch(np.zeros((2, 5), np.float32))


def _query_dim_mismatch(pkg, kw):
    idx = _index(pkg, kw)
    idx.add_dense_batch(np.zeros((2, 4), np.float32))
    idx.knn_query_batch(np.zeros((2, 6), np.float32), 1)


def _unknown_space(pkg, kw):
    pkg.Index("no_such_space", method="hnsw", **kw)


def _unknown_method(pkg, kw):
    idx = _index(pkg, kw, method="no_such_method")
    idx.add_dense_batch(np.zeros((2, 4), np.float32))
    idx.build_index()


def _unused_param(pkg, kw):
    idx = _index(pkg, kw)
    idx.add_dense_batch(np.zeros((3, 4), np.float32))
    idx.build_index(pkg.Params(chunkSize=8, bogusKnob=1))


def _unused_query_param(pkg, kw):
    idx = _index(pkg, kw)
    idx.add_dense_batch(np.zeros((3, 4), np.float32))
    idx.set_query_time_params(pkg.Params(efSearch=10))


def _missing_dim(pkg, kw):
    _index(pkg, kw, dim=None)


def _bad_param_entry(pkg, kw):
    pkg.Params(["novalue"])


def _synonym_conflict(pkg, kw):
    mod = JP if pkg is tpu_knn else TP
    mod.ParamManager(pkg.Params(ef=1, efSearch=2)).get_synonym(["ef", "efSearch"], 10, int)


@pytest.mark.parametrize(
    "scenario,match",
    [
        (_k_zero, "k must be positive"),
        (_k_zero_batch, "k must be positive"),
        (_dim_mismatch, "dim"),
        (_query_dim_mismatch, "dim"),
        (_unknown_space, "unknown space"),
        (_unknown_method, "unknown method"),
        (_unused_param, "unknown parameters"),
        (_unused_query_param, "unknown parameters"),
        (_missing_dim, "requires a 'dim'"),
        (_bad_param_entry, "key=value"),
        (_synonym_conflict, "conflicting"),
    ],
)
def test_error_parity(scenario, match):
    je, te = _both(scenario)
    assert isinstance(te, TE.InvalidArgumentError) and te.code == je.code == 2
    assert match in str(je) and match in str(te)


def test_error_taxonomy_matches():
    assert {c: cls.__name__ for c, cls in JE.ERROR_BY_CODE.items()} == {
        c: cls.__name__ for c, cls in TE.ERROR_BY_CODE.items()
    }
    assert sorted(n for n in dir(tpu_knn) if n.endswith("Error")) == sorted(
        n for n in dir(tpu_knn_torch) if n.endswith("Error")
    )


def test_registry_parity():
    assert sorted(tpu_knn_torch.__all__) == sorted(tpu_knn.__all__)
    assert tpu_knn_torch.clear_upload_cache() == 0
    assert TR.SPACE_TYPES_WHITELIST == JR.SPACE_TYPES_WHITELIST
    assert TR.SPACE_ALIASES == JR.SPACE_ALIASES
    # every dense space of tpu_knn; the sparse, string, bit, embed, fusion
    # and sqfd spaces come in later slices
    dense = sorted(n for n, c in JR._SPACES.items() if c.__module__ == "tpu_knn.spaces.dense")
    assert tpu_knn_torch.known_spaces() == dense and len(dense) == 30
    assert set(tpu_knn_torch.known_spaces()) <= set(tpu_knn.known_spaces())
    assert tpu_knn_torch.known_methods() == ["brute_force", "hnsw", "seq_search"]
    for name in ("l2", "cosine", "sparse_l2", "no_such_space"):
        assert tpu_knn_torch.is_valid_space_type(name) == tpu_knn.is_valid_space_type(name)


def test_empty_index_and_metadata():
    out = []
    for pkg, kw in PKGS:
        idx = _index(pkg, kw, method="brute_force")
        d, i = idx.knn_query_batch(np.zeros((2, 4), np.float32), 3)
        assert (i == -1).all() and np.isinf(d).all()
        out.append((idx.get_space_type(), idx.get_method(), idx.get_data_type().value,
                    idx.get_dist_type().value, idx.data_qty()))
    assert out[0] == out[1]


def test_memory_usage_is_tensor_bytes():
    idx = _index(tpu_knn_torch, {"device": "cpu"}, dim=8)
    assert idx.memory_usage_bytes() == 0
    idx.add_dense_batch(np.ones((10, 8), np.float32))
    idx.build_index()
    data = idx.method.data
    want = data.vecs.nbytes + data.ids.nbytes + data.row_term.nbytes + data.extra["pad"].nbytes
    assert idx.memory_usage_bytes() == want == 16 * 128 * 4 + 16 * 4 * 3


def test_cuda_device_without_cuda_fails_loudly(monkeypatch):
    """The default device is cuda; with no card it raises, never drops to CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TE.InvalidArgumentError, match="cuda"):
        tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=4), method="seq_search")
    with pytest.raises(TE.InvalidArgumentError, match="mesh"):
        tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=4), method="seq_search", device="cpu", mesh=2)


def test_auto_rebuild_after_add():
    idx = _index(tpu_knn_torch, {"device": "cpu"})
    x = np.eye(4, dtype=np.float32)
    idx.add_dense_batch(x[:2])
    assert idx.knn_query(x[0], 5).ids.tolist() == [0, 1]
    idx.add_dense_batch(x[2:], ids=[7, 9])
    res = idx.knn_query_batch_results(x[2:], 1)
    assert [r.ids.tolist() for r in res] == [[7], [9]]
    assert idx.get_distance(0, 1) == pytest.approx(np.sqrt(2.0), rel=1e-6)


def test_utils_rng_timer_logging():
    from tpu_knn_torch.utils import logging as L, rng, timer

    rng.set_default_seed(5)
    try:
        a = rng.np_rng().standard_normal(3)
        b = torch.rand(3, generator=rng.torch_generator())
        np.testing.assert_array_equal(a, np.random.default_rng(5).standard_normal(3))
        assert torch.equal(b, torch.rand(3, generator=torch.Generator().manual_seed(5)))
    finally:
        rng.set_default_seed(0)
    t = timer.WallClockTimer()
    t.split()
    assert t.elapsed() >= 0.0
    seen = []
    L.LOGGER.set_custom(lambda level, msg: seen.append((level, msg)))
    try:
        L.log("INFO", "hello")
        L.log("DEBUG", "dropped")
    finally:
        L.LOGGER.set_stderr()
    assert seen == [("INFO", "hello")]
    with pytest.raises(TE.RuntimeNmsError):
        L.check(False, "boom")


def test_default_method_builds_and_answers_in_both_packages():
    """Index("l2", {"dim": 4}) with no method= is hnsw in both packages, builds
    and answers alike."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((60, 4)).astype(np.float32)
    out = []
    for pkg, kw in PKGS:
        idx = pkg.Index("l2", {"dim": 4}, **kw)
        assert idx.get_method() == "hnsw"
        idx.add_dense_batch(x)
        d, i = idx.knn_query_batch(x[:9] + 0.01, 3)  # auto-builds
        assert type(idx.method).__name__ == "Hnsw" and idx.built
        res = idx.knn_query(x[5], 1)
        assert res.ids[0] == 5
        out.append((d, i))
    (d1, i1), (d2, i2) = out
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d2, d1, rtol=5e-3, atol=1e-5)
    assert (i2[:, 0] == np.arange(9)).all() and i2.dtype == np.int32
