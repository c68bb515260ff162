"""Range search, tpu_knn.Index against tpu_knn_torch.Index(device="cpu")
on the same data, for l2, l2sqr_sift and cosinesimil, at radii with no
hit, a few hits and more than 128 hits (the result cap's next bucket)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.core.errors import IndexNotBuiltError  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402
from tpu_knn_torch.methods import base as TB  # noqa: E402
from tpu_knn_torch.methods import seq_search as TSS  # noqa: E402

DIM = 24
N = 3001  # not a multiple of 128 (nor of 8): padded to 3008


def _pair(space, x, params=None, **kw):
    out = []
    for pkg, dev in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index(space, pkg.Params(dim=x.shape[1]) if space != "l2sqr_sift" else None,
                        method="seq_search", **kw, **dev)
        (idx.add_uint8_batch if space == "l2sqr_sift" else idx.add_dense_batch)(x)
        idx.build_index(pkg.Params(params or {}))
        out.append(idx)
    return out


def _exact(space, q, x):
    q, x = q.astype(np.float64), x.astype(np.float64)
    if space == "l2":
        return np.sqrt(((q[:, None, :] - x[None]) ** 2).sum(-1))
    if space == "l2sqr_sift":
        return ((q[:, None, :] - x[None]) ** 2).sum(-1)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    return 1.0 - qn @ xn.T


def _check(space, x, q, radius, ref, got, exact_ints=False):
    ex = _exact(space, q, x)
    assert len(got) == len(ref) == len(q)
    for j, (g, w) in enumerate(zip(got, ref)):
        assert g.ids.dtype == w.ids.dtype == np.int32
        assert g.dists.dtype == w.dists.dtype == np.float32
        assert (g.dists <= radius).all() and (np.diff(g.dists) >= 0).all()
        assert len(set(g.ids.tolist())) == len(g.ids)
        if exact_ints:  # integer distances: the same hits in the same order
            np.testing.assert_array_equal(g.ids, w.ids)
            np.testing.assert_array_equal(g.dists, w.dists)
            np.testing.assert_array_equal(g.dists, ex[j, g.ids])
            assert len(g) == int((ex[j] <= radius).sum())
            continue
        # membership may differ only for points whose exact distance ties
        # the radius within f32 noise
        odd = np.setxor1d(g.ids, w.ids)
        assert (np.abs(ex[j, odd] - radius) <= 1e-5 * abs(radius) + 1e-6).all(), (j, odd)
        common, gi, wi = np.intersect1d(g.ids, w.ids, return_indices=True)
        np.testing.assert_allclose(g.dists[gi], w.dists[wi], rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(g.dists, ex[j, g.ids], rtol=5e-3, atol=1e-5)


def _data(space):
    if space == "l2sqr_sift":
        x = np.clip(np.rint(clustered(N, 128, seed=41) * 40.0 + 128.0), 0, 255).astype(np.uint8)
        q = np.concatenate([x[:3], np.clip(np.rint(clustered(6, 128, seed=42) * 40.0 + 128.0), 0, 255)
                            .astype(np.uint8)])
        return x, q
    x = clustered(N, DIM, seed=43)
    return x, np.concatenate([x[:3] + 0.01, clustered(6, DIM, seed=44)])


@pytest.mark.parametrize("which", ["none", "few", "over128"])
@pytest.mark.parametrize("space", ["l2", "l2sqr_sift", "cosinesimil"])
def test_range_matches_tpu_knn(space, which):
    x, q = _data(space)
    kw = {"data_type": "dense_uint8_vector", "dist_type": "int"} if space == "l2sqr_sift" else {}
    jidx, tidx = _pair(space, x, **kw)
    ex = _exact(space, q, x)
    srt = np.sort(ex, axis=1)
    if which == "none":
        radius = float(srt[:, 0].min()) * 0.5 - (1.0 if space == "l2sqr_sift" else 0.0)
        radius = max(radius, -1.0)
    elif which == "few":  # at most 3 hits for every query: the smallest 3rd-4th midpoint
        radius = float(srt[:, 2:4].mean(1).min())
    else:  # past the 300th neighbour of the median query
        radius = float(np.median(srt[:, 300]))
    if space == "l2sqr_sift":
        radius = float(np.floor(radius))
    ref, got = jidx.range_query_batch(q, radius), tidx.range_query_batch(q, radius)
    _check(space, x, q, radius, ref, got, exact_ints=space == "l2sqr_sift")
    counts = [len(g) for g in got]
    if which == "none":
        assert counts == [0] * len(q)
    elif which == "few":
        assert max(counts) == 3
    else:
        assert max(counts) > 128
    assert tidx.method.dist_comps == jidx.method.dist_comps == len(q) * N


def test_range_cap_clipped_to_the_padded_corpus(monkeypatch):
    """A radius that takes every row: the cap (3001 rounded up to 3072) is
    clipped to n_pad = 3008, and padding rows never count."""
    x, q = _data("l2")
    jidx, tidx = _pair("l2", x)
    caps = []
    orig = TSS._range_collect_device
    monkeypatch.setattr(TSS, "_range_collect_device",
                        lambda *a: caps.append(a[4]) or orig(*a))
    got, ref = tidx.range_query_batch(q[:4], 1e20), jidx.range_query_batch(q[:4], 1e20)
    assert caps == [3008] and tidx.method.data.ids.shape[0] == 3008
    for g, w in zip(got, ref):
        assert len(g) == len(w) == N
        np.testing.assert_array_equal(np.sort(g.ids), np.arange(N))


def test_range_query_single_point_and_custom_ids():
    x = clustered(500, DIM, seed=45)
    ids = np.arange(500) * 3 + 1
    out = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, {"device": "cpu"})):
        idx = pkg.Index("l2", pkg.Params(dim=DIM), method="seq_search", **kw)
        idx.add_dense_batch(x, ids=ids)
        out.append(idx.range_query(x[7] + 0.01, 0.5))
    (w, g) = out
    assert 7 * 3 + 1 in g.ids.tolist()
    np.testing.assert_array_equal(g.ids, w.ids)
    np.testing.assert_allclose(g.dists, w.dists, rtol=5e-3, atol=1e-5)


def test_stream_range_results_contract():
    """Empty counts make no collect call; the cap is the largest count
    rounded up to 128; ids keep data.ids' int32."""
    class Data:
        ids = torch.arange(1024, dtype=torch.int32) * 2

    calls = []

    def collect(cap):
        calls.append(cap)
        d = torch.full((2, cap), float("inf"))
        p = torch.full((2, cap), -1, dtype=torch.int64)
        d[0, :3], p[0, :3] = torch.tensor([0.5, 1.0, 2.0]), torch.tensor([4, 0, 9])
        return d, p

    empty = TB.stream_range_results(np.zeros(2, np.int32), Data, collect)
    assert calls == [] and all(len(i) == 0 and i.dtype == np.int32 and d.dtype == np.float32
                               for i, d in empty)
    res = TB.stream_range_results(np.asarray([3, 0], np.int32), Data, collect)
    assert calls == [128]
    assert res[0][0].tolist() == [8, 0, 18] and res[0][0].dtype == np.int32
    assert res[0][1].tolist() == [0.5, 1.0, 2.0] and len(res[1][0]) == 0


def test_range_needs_a_built_index():
    m = TSS.SeqSearch(tpu_knn_torch.core.registry.create_space("l2", {"dim": 4}, device="cpu"))
    with pytest.raises(IndexNotBuiltError):
        m.range(np.zeros((1, 4), np.float32), 1.0)
    assert TSS.SeqSearch.supports_range
