"""HNSW in the port (device="cpu") against tpu_knn: search over a graph
tpu_knn built and saved (persist v3) and the reverse, the port's wave
build against tpu_knn's on the same data and seed, the cases of
tests/test_hnsw.py and tests/test_determinism.py that need nothing
unported, and the routing between the build algorithms.

Ids must be equal except where two ids are tied in exact (float64)
distance; distances within rtol 5e-3, atol 1e-5; ``dist_comps`` equal where
the ids are."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch import Index, Params  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError, SpaceIncompatibleError  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered, sift_like  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
BUILD = dict(M=8, efConstruction=60, waveSize=128, seed=0)


def _recall(i, gi, k):
    return float(np.mean([len(set(gi[r]) & set(i[r])) / k for r in range(len(gi))]))


def _index(pkg, space, x, build=None, method="hnsw", **kw):
    kw = dict(kw, **(CPU if pkg is tpu_knn_torch else {}))
    idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method=method, **kw)
    idx.add_dense_batch(x)
    if build is not None:
        idx.build_index(pkg.Params(build))
    return idx


def _exact_dist(space, q, x):
    q, x = q.astype(np.float64), x.astype(np.float64)
    if space == "l2":
        return np.linalg.norm(q - x)
    c = q @ x / (np.linalg.norm(q) * np.linalg.norm(x))
    return float(np.arccos(np.clip(c, -1, 1)))


def _assert_same_knn(space, x, q, ref, got):
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):  # only exact ties may swap
        da, db = _exact_dist(space, q[r], x[i1[r, c]]), _exact_dist(space, q[r], x[i2[r, c]])
        assert abs(da - db) <= 1e-5 * max(da, db) + 1e-6, (r, c, i1[r, c], i2[r, c], da, db)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_hnsw.py's corpus."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((800, 24)).astype(np.float32)
    q = rng.standard_normal((50, 24)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory, corpus):
    """tpu_knn builds once per case and saves with persist v3."""
    x, _ = corpus
    out = {}
    for space, n in (("l2", 800), ("angulardist", 800), ("l2", 333)):
        idx = _index(tpu_knn, space, x[:n], BUILD)
        path = str(tmp_path_factory.mktemp("jax") / f"{space}_{n}")
        idx.save(path)
        out[space, n] = (idx, path)
    return out


# ---------------- (b) a graph carried across, both ways ----------------


@pytest.mark.parametrize("space,n", [("l2", 800), ("angulardist", 800), ("l2", 333)])
def test_port_searches_a_graph_tpu_knn_saved(jax_saved, corpus, space, n):
    x, q = corpus
    jidx, path = jax_saved[space, n]
    tidx = Index.load(path, **CPU)
    m = tidx.method
    assert tidx.get_method() == "hnsw" and m._qenc_all is None
    np.testing.assert_array_equal(m.graph["level0"].numpy(), np.asarray(jidx.method.graph["level0"]))
    assert m.graph["level0"].dtype == torch.int32 and len(m._upper) == len(jidx.method._upper)
    assert m.check_graph() == jidx.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    for k in (1, 10):
        for ef in (20, 100):
            jidx.set_query_time_params(tpu_knn.Params(efSearch=ef))
            tidx.set_query_time_params(Params(efSearch=ef))
            jidx.method.dist_comps = tidx.method.dist_comps = 0
            ref, got = jidx.knn_query_batch(q, k), tidx.knn_query_batch(q, k)
            _assert_same_knn(space, x, q, ref, got)
            if np.array_equal(ref[1], got[1]):
                assert tidx.method.dist_comps == jidx.method.dist_comps > 0


@pytest.mark.parametrize("space", ["l2", "angulardist"])
def test_tpu_knn_searches_a_graph_the_port_saved(tmp_path, corpus, space):
    x, q = corpus
    tidx = _index(tpu_knn_torch, space, x[:500], BUILD)
    path = str(tmp_path / "port")
    tidx.save(path)
    with np.load(path + ".idx.npz") as z:  # tpu_knn's keys and dtypes
        assert {"state_level0", "state_levels", "state_order", "state_meta", "state_upper_0"} <= set(z.files)
        assert z["state_level0"].dtype == z["state_levels"].dtype == z["state_upper_0"].dtype == np.int32
        assert z["state_order"].dtype == z["state_meta"].dtype == np.int64
    jidx = tpu_knn.Index.load(path)
    for ef in (20, 100):
        jidx.set_query_time_params(tpu_knn.Params(efSearch=ef))
        tidx.set_query_time_params(Params(efSearch=ef))
        _assert_same_knn(space, x, q, jidx.knn_query_batch(q, 10), tidx.knn_query_batch(q, 10))


# ---------------- (c) the port's build against tpu_knn's ----------------


def test_build_matches_tpu_knn(jax_saved, corpus):
    x, q = corpus
    jm = jax_saved["l2", 800][0].method
    tidx = _index(tpu_knn_torch, "l2", x, BUILD)
    tm = tidx.method
    np.testing.assert_array_equal(tm.levels, jm.levels)
    np.testing.assert_array_equal(tm.order, jm.order)
    assert tm.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    assert [tuple(u.shape) for u in tm._upper] == [tuple(u.shape) for u in jm._upper]
    l0j, l0t = np.asarray(jm.graph["level0"])[:800], tm.graph["level0"].numpy()[:800]
    share = float(np.mean([set(a) == set(b) for a, b in zip(l0j, l0t)]))
    print(f"level-0 rows with tpu_knn's neighbour set: {share:.4f}")
    # found 1.0 (the two graphs are equal, array for array) on x86-64; a
    # near-tie that f32 rounding orders differently changes a few rows
    assert share >= 0.99
    _, gi = _index(tpu_knn_torch, "l2", x, method="seq_search").knn_query_batch(q, 10)
    jidx = jax_saved["l2", 800][0]
    for ef in (20, 100):
        jidx.set_query_time_params(tpu_knn.Params(efSearch=ef))
        tidx.set_query_time_params(Params(efSearch=ef))
        rj = _recall(jidx.knn_query_batch(q, 10)[1], gi, 10)
        rt = _recall(tidx.knn_query_batch(q, 10)[1], gi, 10)
        assert abs(rj - rt) <= 0.02, (ef, rj, rt)


# ---------------- (d) tests/test_hnsw.py's cases on the port ----------------


@pytest.fixture(scope="module")
def built(corpus):
    return _index(tpu_knn_torch, "l2", corpus[0], BUILD)


def test_hnsw_recall_l2(built, corpus):
    x, q = corpus
    _, gi = _index(tpu_knn_torch, "l2", x, method="seq_search").knn_query_batch(q, 10)
    built.set_query_time_params(Params(efSearch=100))
    assert _recall(built.knn_query_batch(q, 10)[1], gi, 10) >= 0.9


def test_hnsw_self_query(built, corpus):
    built.set_query_time_params(Params(efSearch=50))
    res = built.knn_query(corpus[0][17], k=1)
    assert res.ids[0] == 17 and res.dists[0] < 1e-2


def test_hnsw_cosine(corpus):
    x, q = corpus
    idx = _index(tpu_knn_torch, "cosinesimil", x, BUILD)
    _, gi = _index(tpu_knn_torch, "cosinesimil", x, method="seq_search").knn_query_batch(q, 10)
    idx.set_query_time_params(Params(efSearch=100))
    assert _recall(idx.knn_query_batch(q, 10)[1], gi, 10) >= 0.9


def test_hnsw_range_raises(corpus):
    idx = _index(tpu_knn_torch, "l2", corpus[0][:100])
    with pytest.raises(SpaceIncompatibleError):
        idx.range_query(corpus[0][0], 1.0)


def test_hnsw_save_load(tmp_path, built, corpus):
    _, q = corpus
    built.set_query_time_params(Params(efSearch=50))
    before = built.knn_query(q[0], k=5)
    p = str(tmp_path / "h")
    built.save(p)
    idx2 = Index.load(p, **CPU)
    idx2.set_query_time_params(Params(efSearch=50))
    after = idx2.knn_query(q[0], k=5)
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.dists, after.dists)
    for a, b in zip([built.method.graph["level0"], *built.method._upper],
                    [idx2.method.graph["level0"], *idx2.method._upper]):
        assert torch.equal(a, b)


def test_hnsw_ef_synonym_conflict(corpus):
    idx = _index(tpu_knn_torch, "l2", corpus[0][:64], dict(M=4, efConstruction=20, waveSize=64))
    with pytest.raises(InvalidArgumentError):
        idx.set_query_time_params(Params(ef=10, efSearch=20))


def test_hnsw_uint8_sift():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 255, (300, 128), dtype=np.uint8)
    idx = Index("l2sqr_sift", Params(dim=128), "hnsw", "dense_uint8_vector", "int", **CPU)
    idx.add_uint8_batch(x)
    idx.build_index(Params(M=8, efConstruction=40, waveSize=128))
    assert not idx.method._cstore_ok() and not idx.method._nbr_store_ok()  # int8 rows: the stores stand down
    idx.set_query_time_params(Params(efSearch=60))
    res = idx.knn_query(x[5], k=3)
    assert res.ids[0] == 5 and res.dists[0] == 0
    assert np.all(res.dists == np.rint(res.dists))


def test_replicate_neighbors_matches_plain():
    """replicateNeighbors=1 (bf16 and int8 neighbourhood stores + exact
    final re-score) against the plain gather path: near-identical recall,
    exact distances for agreeing ids, and the store counted in
    memory_usage_bytes."""
    x = clustered(800, 32, n_clusters=20, latent_dim=8, seed=5)
    q = x[:64] + 0.01
    build = dict(M=8, efConstruction=40, waveSize=256, seed=3)
    base = _index(tpu_knn_torch, "l2", x, build)
    d0, i0 = base.knn_query_batch(q, 10)
    assert base.method._get_nbr_store() is None
    for dtype in ("bfloat16", "int8"):
        rep = _index(tpu_knn_torch, "l2", x, dict(build, replicateNeighbors=1, nbrStoreDtype=dtype))
        assert torch.equal(rep.method.graph["level0"], base.method.graph["level0"])
        before = rep.memory_usage_bytes()  # the store is made at the first query
        d1, i1 = rep.knn_query_batch(q, 10)
        store = rep.method._nbr_store[1]
        assert store.dtype == getattr(torch, dtype) and store.shape == (800, 16, 128)
        assert rep.memory_usage_bytes() == before + store.nbytes
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i0, i1)])
        assert overlap > 0.95, (dtype, overlap)
        for a_ids, a_d, b_ids, b_d in zip(i0, d0, i1, d1):
            bm = {int(i): float(v) for i, v in zip(b_ids, b_d)}
            for i, v in zip(a_ids, a_d):
                if int(i) in bm:
                    np.testing.assert_allclose(bm[int(i)], float(v), rtol=RTOL, atol=ATOL)


def test_replicate_neighbors_matches_tpu_knn(jax_saved, corpus):
    """The store branch of _search_core, against tpu_knn over its graph."""
    x, q = corpus
    _, path = jax_saved["l2", 800]
    for dtype in ("bfloat16", "int8"):
        jidx, tidx = tpu_knn.Index.load(path), Index.load(path, **CPU)
        for m in (jidx.method, tidx.method):
            m.replicate_neighbors, m.nbr_store_dtype = 1, dtype
        ref, got = jidx.knn_query_batch(q, 10), tidx.knn_query_batch(q, 10)
        _assert_same_knn("l2", x, q, ref, got)
        assert tidx.method.dist_comps == jidx.method.dist_comps


@pytest.mark.slow
def test_wave_ramp_small_corpus_recall():
    """waveSize comparable to the corpus: the ramped head (128, 128, 256,
    512, then 1024) keeps the routing backbone sound."""
    n = 2048
    x = sift_like(n + 128, 128, seed=0)
    _, gi = _index(tpu_knn_torch, "l2", x[:n], method="seq_search").knn_query_batch(x[n:], 10)
    idx = _index(tpu_knn_torch, "l2", x[:n], dict(M=16, efConstruction=100, waveSize=1024))
    idx.set_query_time_params(Params(efSearch=50))
    assert _recall(idx.knn_query_batch(x[n:], 10)[1], gi, 10) >= 0.97
    _, sids = idx.knn_query_batch(x[:64], 10)
    assert float(np.mean(sids[:, 0] == np.arange(64))) == 1.0


@pytest.mark.slow
def test_wave_ramp_schedule_matches_tpu_knn():
    """The same schedule at a small width: n=700, waveSize=512 ramps to
    128, 128, 256, then 512, and the two graphs agree."""
    x = clustered(700, 16, n_clusters=10, latent_dim=6, seed=2)
    build = dict(M=6, efConstruction=30, waveSize=512, seed=1)
    jm = _index(tpu_knn, "l2", x, build).method
    tm = _index(tpu_knn_torch, "l2", x, build).method
    l0j, l0t = np.asarray(jm.graph["level0"])[:700], tm.graph["level0"].numpy()[:700]
    assert np.mean([set(a) == set(b) for a, b in zip(l0j, l0t)]) >= 0.99
    assert tm.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}


def test_graph_sanity_checkers():
    x = clustered(1000, 16, n_clusters=20, latent_dim=6, seed=1)
    idx = _index(tpu_knn_torch, "l2", x, dict(M=6, efConstruction=40, waveSize=128))
    chk = idx.method.check_graph()
    assert chk == {"self_links": 0, "dup_links": 0, "oob_links": 0}, chk
    hist = idx.method.degree_distribution()
    assert hist.sum() == 1000 and hist.shape == (13,)
    assert np.average(np.arange(hist.shape[0]), weights=hist) >= 3
    # the checker sees what it is for
    bad = idx.method.graph["level0"]
    bad[5, 0], bad[6, 0], bad[6, 1], bad[7, 0] = 5, 9, 9, 1000
    assert idx.method.check_graph() == {"self_links": 1, "dup_links": 1, "oob_links": 1}


def test_construction_state_lifetime(rng, tmp_path):
    """Wave encodings (a second corpus copy) are construction-only: dropped
    after build and after restore."""
    x = rng.standard_normal((256, 16)).astype(np.float32)
    idx = _index(tpu_knn_torch, "l2", x, dict(M=4, efConstruction=10, waveSize=32))
    m = idx.method
    assert m._qenc_all is None and m._proxy is None and m._graph_data is m.data
    assert m.KEEP_WAVE_STATE is False
    idx.save(str(tmp_path / "s"))
    m2 = Index.load(str(tmp_path / "s"), **CPU).method
    assert m2._qenc_all is None and m2._graph_data is m2.data


@pytest.mark.slow
def test_delaunay_type_zero_naive_selection():
    x = sift_like(2048 + 64, 32, seed=7)
    c, q = x[:2048], x[2048:]
    _, gold = _index(tpu_knn_torch, "l2", c, method="seq_search").knn_query_batch(q, 10)
    idx = _index(tpu_knn_torch, "l2", c, dict(M=8, efConstruction=50, waveSize=128, delaunay_type=0))
    deg = (idx.method.graph["level0"].numpy() >= 0).sum(1)
    assert deg[2048 // 2:].mean() >= 8
    idx.set_query_time_params(Params(efSearch=100))
    assert _recall(idx.knn_query_batch(q, 10)[1], gold, 10) >= 0.6


@pytest.mark.slow
def test_delaunay_type_zero_matches_tpu_knn():
    x = clustered(500, 16, n_clusters=10, latent_dim=6, seed=4)
    build = dict(M=6, efConstruction=30, waveSize=128, delaunay_type=0, post=1)
    jm = _index(tpu_knn, "l2", x, build).method
    tm = _index(tpu_knn_torch, "l2", x, build).method
    l0j, l0t = np.asarray(jm.graph["level0"])[:500], tm.graph["level0"].numpy()[:500]
    assert np.mean([set(a) == set(b) for a, b in zip(l0j, l0t)]) >= 0.99


def test_query_param_reset_restores_expand(rng):
    x = rng.standard_normal((256, 16)).astype(np.float32)
    idx = _index(tpu_knn_torch, "l2", x, dict(M=4, efConstruction=10, waveSize=32))
    m = idx.method
    default = m.expand
    idx.set_query_time_params(Params(searchExpand=64, efSearch=50))
    assert m.expand == 64
    idx.set_query_time_params(None)
    assert m.expand == default and m.ef_search == m.DEFAULT_EF_SEARCH
    with pytest.raises(InvalidArgumentError):
        idx.set_query_time_params(Params(efSearhc=5))


def test_construction_store_recall_and_gating(corpus):
    """constructionStore=1 (the default): the level-0 construction beam rides
    an int8 store kept across waves, post passes included; selection
    re-scores exactly, so recall matches the plain build's closely."""
    x, q = corpus[0][:600], corpus[1]
    _, gi = _index(tpu_knn_torch, "l2", x, method="seq_search").knn_query_batch(q, 10)
    recalls = {}
    for cs in (0, 1):
        build = dict(BUILD, post=1, constructionStore=cs)
        idx = _index(tpu_knn_torch, "l2", x, build)
        assert idx.method._cstore_ok() is True
        idx.set_query_time_params(Params(efSearch=100))
        recalls[cs] = _recall(idx.knn_query_batch(q, 10)[1], gi, 10)
        lv0 = idx.method.graph["level0"].numpy()
        assert not (lv0[:600] == np.arange(600)[:, None]).any()  # no self links
        assert idx.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    assert recalls[1] >= recalls[0] - 0.02


@pytest.mark.slow
@pytest.mark.parametrize("cs", [0, 1])
def test_construction_store_and_post_pass_match_tpu_knn(corpus, cs):
    x, _ = corpus
    build = dict(BUILD, post=1, constructionStore=cs)
    jl0 = np.asarray(_index(tpu_knn, "l2", x, build).method.graph["level0"])[:800]
    tl0 = _index(tpu_knn_torch, "l2", x, build).method.graph["level0"].numpy()[:800]
    assert np.mean([set(a) == set(b) for a, b in zip(jl0, tl0)]) >= 0.99


@pytest.mark.slow
def test_post_pass_with_ramped_schedule(rng):
    """post passes iterate a uniform width-w grid even when the head ramp
    added extra waves to the build schedule."""
    n = 2048
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    _, gi = _index(tpu_knn_torch, "l2", x, method="seq_search").knn_query_batch(q, 10)
    recalls = {}
    for post in (0, 1):
        idx = _index(tpu_knn_torch, "l2", x, dict(M=8, efConstruction=40, waveSize=1024, seed=0, post=post))
        idx.set_query_time_params(Params(efSearch=64))
        recalls[post] = _recall(idx.knn_query_batch(q, 10)[1], gi, 10)
        assert idx.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    assert recalls[1] >= recalls[0] - 0.02 and recalls[1] >= 0.85


@pytest.mark.slow
def test_post_pass_with_ramped_schedule_small(rng):
    """The same at n=600, waveSize=512 (the ramp fires: 512 > 128 and
    > n//64), against tpu_knn's graph."""
    x = rng.standard_normal((600, 16)).astype(np.float32)
    build = dict(M=6, efConstruction=30, waveSize=512, seed=0, post=1)
    jm = _index(tpu_knn, "l2", x, build).method
    tm = _index(tpu_knn_torch, "l2", x, build).method
    assert tm.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    l0j, l0t = np.asarray(jm.graph["level0"])[:600], tm.graph["level0"].numpy()[:600]
    assert np.mean([set(a) == set(b) for a, b in zip(l0j, l0t)]) >= 0.99


# ---------------- tests/test_determinism.py's HNSW cases ----------------


def _det_build(seed=11):
    x = clustered(1000, 24, n_clusters=30, latent_dim=6, seed=7)
    return _index(tpu_knn_torch, "l2", x, dict(M=6, efConstruction=40, waveSize=128, seed=seed)), x


def test_same_seed_identical_graph_and_results():
    a, x = _det_build()
    b, _ = _det_build()
    assert torch.equal(a.method.graph["level0"], b.method.graph["level0"])
    assert len(a.method._upper) == len(b.method._upper) > 0
    for ua, ub in zip(a.method._upper, b.method._upper):
        assert torch.equal(ua, ub)
    da, ia = a.knn_query_batch(x[:64], 5)
    db, ib = b.knn_query_batch(x[:64], 5)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)
    c, _ = _det_build(seed=12)  # another seed, another graph
    assert not np.array_equal(a.method.levels, c.method.levels)


def test_query_batch_order_invariance():
    """Each query's result must not depend on its batch position."""
    idx, x = _det_build()
    q = x[10:42].copy()
    _, fwd = idx.knn_query_batch(q, 5)
    _, rev = idx.knn_query_batch(q[::-1].copy(), 5)
    np.testing.assert_array_equal(fwd, rev[::-1])


# ---------------- (e) build routing and what is refused ----------------


def test_nndescent_builds_raise_and_name_waves(corpus):
    """buildAlgo="nndescent", and "auto" at or above buildAlgoAutoN, build
    level 0 by NN-descent, as tpu_knn routes them (the builds themselves are
    held to tpu_knn's in tests/test_torch_hnsw_nnd.py); "auto" below the
    threshold and "waves" above it build by waves."""
    x, _ = corpus
    small = dict(M=4, efConstruction=10, waveSize=64, nndChunk=128, nndIters=2, nndK=8, nndKrev=4)
    cases = ((dict(buildAlgo="nndescent"), "nndescent"), (dict(buildAlgoAutoN=200), "nndescent"),
             (dict(buildAlgoAutoN=201), "waves"), (dict(buildAlgo="waves", buildAlgoAutoN=100), "waves"))
    for params, algo in cases:
        idx = _index(tpu_knn_torch, "l2", x[:200], dict(small, **params))
        m = idx.method
        assert m._resolve_build_algo(200) == algo and m._will_use_nnd(200) == (algo == "nndescent")
        assert idx.built and m._qenc_all is None
        assert m.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
        assert idx.knn_query(x[3], 1).ids[0] == 3


@pytest.mark.parametrize("params,err", [
    (dict(notAParam=1), "invalid"), (dict(buildAlgo="bogus"), "value"),
    (dict(nndStoreDtype="fp8"), "value"), (dict(nndRevMode="x"), "value"), (dict(nbrStoreDtype="fp16"), "value"),
])
def test_bad_parameters_raise_as_in_tpu_knn(corpus, params, err):
    x, _ = corpus
    for pkg in (tpu_knn, tpu_knn_torch):
        idx = _index(pkg, "l2", x[:50])
        exc = ValueError if err == "value" else pkg.core.errors.InvalidArgumentError
        with pytest.raises(exc):
            idx.build_index(pkg.Params(params))


def test_every_tpu_knn_parameter_is_parsed():
    """A header tpu_knn saved loads: every index-time parameter it parses is
    parsed, with the same default."""
    names = ["M", "maxM", "maxM0", "efConstruction", "mult", "delaunay_type", "post", "indexThreadQty",
             "skip_optimized_index", "waveSize", "waveMates", "searchExpand", "constructionExpand", "buildAlgo",
             "buildAlgoAutoN", "nndK", "nndKrev", "nndT", "nndIters", "nndChunk", "nndLevelK", "nndStoreDtype",
             "nndFillPruned", "nndRandom", "nndRevMode", "nndPolish", "nndPolishStore", "nndProfile",
             "replicateNeighbors", "sketchDim", "sketchQuery", "exactBase", "exactPairs", "exactPost",
             "exactShrink", "nbrStoreDtype", "constructionStore", "seed"]
    js = tpu_knn.core.registry.create_space("l2", tpu_knn.Params(dim=4))
    ts = tpu_knn_torch.core.registry.create_space("l2", Params(dim=4), device="cpu")
    jm, tm = tpu_knn.methods.hnsw.Hnsw(js), TH.Hnsw(ts)
    # vocab_floor is not a parameter: a knob of the corpus-sharded build for sparse encodes
    attrs = [a for a, v in vars(jm).items()
             if isinstance(v, (int, float, str)) and not a.startswith("_") and a != "vocab_floor"]
    assert len(attrs) > 30
    for a in attrs:
        assert getattr(tm, a) == getattr(jm, a), a
    for name in names:  # each is consumed: check_unused passes, in both
        val = {"buildAlgo": "waves", "nndStoreDtype": "int8", "nndRevMode": "slots",
               "nbrStoreDtype": "int8", "mult": 0.5}.get(name, 3)
        tpu_knn.methods.hnsw.Hnsw(js, tpu_knn.Params({name: val}))
        TH.Hnsw(ts, Params({name: val}))


def test_print_progress_logs_waves(corpus):
    from tpu_knn_torch.utils import logging as L

    lines = []
    L.LOGGER.set_custom(lambda level, msg: lines.append(msg))
    try:
        idx = _index(tpu_knn_torch, "l2", corpus[0][:300])
        idx.build_index(Params(M=4, efConstruction=10, waveSize=64), print_progress=True)
    finally:
        L.LOGGER.set_stderr()
    assert idx.method.progress is True
    assert any("hnsw build: wave 1/" in ln for ln in lines)
