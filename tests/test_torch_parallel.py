"""The port's mesh layer (tpu_knn_torch.parallel, device="cpu") against
tpu_knn's on its 8 virtual CPU devices: the counterpart of each of
tests/test_parallel.py's cases, on the same seeded inputs.

The port runs its shards on make_mesh(S, device="cpu"): S logical shards
on the one CPU device. Exact kNN ids equal tpu_knn's sharded ids,
integer-valued rows (exact ties) included, on both per-shard routes
(chunked block scan and two-pass); distances within rtol 5e-3 / atol
1e-5. Sharded HNSW: per-row level-0 neighbour sets equal tpu_knn's on
both build routes (stacked waves and per-shard builds), recall@10 within
0.005 of tpu_knn's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.parallel import hnsw_sharded as JHS, mesh as JM, sharded as JSH  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError  # noqa: E402
from tpu_knn_torch.parallel import hnsw_sharded as THS, mesh as TM, sharded as TSH  # noqa: E402

CPU = {"device": "cpu"}
RTOL, ATOL = 5e-3, 1e-5
WAVES = dict(M=8, efConstruction=40, waveSize=128)


def _pkg_space(pkg, name, params=None):
    kw = CPU if pkg is tpu_knn_torch else {}
    return pkg.core.registry.create_space(name, params, **kw)


def _store(pkg, kind, pts):
    st = pkg.core.dataset.DataStore(pkg.core.dataset.DataKind(kind))
    if kind == "dense_vector":
        st.add_dense_batch(pts)
    else:
        st.add_sparse_batch(pts)
    return st


def _mesh(pkg, s):
    return JM.make_mesh(s) if pkg is tpu_knn else TM.make_mesh(s, device="cpu")


def _index(pkg, x, method, mesh=None, dim=None):
    kw = CPU if pkg is tpu_knn_torch else {}
    idx = pkg.Index("l2", pkg.Params(dim=dim or x.shape[1]), method=method, mesh=mesh, **kw)
    idx.add_dense_batch(x)
    return idx


def _recall(ids, gold):
    k = gold.shape[1]
    return float(np.mean([len(set(a[a >= 0]) & set(b)) / k for a, b in zip(np.asarray(ids), gold)]))


def _sparse_points(rng, n, vocab, lo, hi):
    pts = []
    for _ in range(n):
        nnz = int(rng.integers(lo, hi))
        ids = np.sort(rng.choice(np.arange(1, vocab), size=nnz, replace=False))
        pts.append((ids, rng.random(nnz).astype(np.float32)))
    return pts


def _exact(pkg, name, kind, pts, q, k, s, precision="float32"):
    space = _pkg_space(pkg, name, pkg.Params(dim=pts.shape[1]) if kind == "dense_vector" else None)
    data = space.encode_dataset(_store(pkg, kind, pts), row_multiple=8 * s)
    d, i = (JSH if pkg is tpu_knn else TSH).sharded_exact_knn(
        space, space.encode_queries(q), data, k, _mesh(pkg, s), precision)
    return np.asarray(d), np.asarray(i)


def _same_graphs(j, p):
    """Level 0 and every upper level: equal neighbour sets in every row of
    every shard; the per-shard host state equal array for array."""
    ja, pa = j.state_arrays(), p.state_arrays()
    assert sorted(ja) == sorted(pa)
    for key in ja:
        a, b = np.asarray(ja[key]), np.asarray(pa[key])
        assert a.shape == b.shape, key
        if key == "level0" or key.startswith("upper_"):
            np.testing.assert_array_equal(np.sort(a, axis=-1), np.sort(b, axis=-1), err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    q = rng.standard_normal((32, 32)).astype(np.float32)
    exact = tpu_knn.Index("l2", tpu_knn.Params(dim=32), method="seq_search")
    exact.add_dense_batch(x)
    gd, gi = exact.knn_query_batch(q, 10)
    return x, q, gd, gi


@pytest.fixture(scope="module")
def sharded_hnsw(setup):
    """tpu_knn's and the port's ShardedHnsw over setup's rows: stacked
    waves (parallelBuild=1) on 8 shards, per-shard builds (0) on 2 (tpu_knn
    compiles each shard's wave programs anew: 2 shards keep it to ~12 s)."""
    x = setup[0]
    out = {}
    for pb, s in ((1, 8), (0, 2)):
        pair = []
        for pkg, mod in ((tpu_knn, JHS), (tpu_knn_torch, THS)):
            sh = mod.ShardedHnsw(_pkg_space(pkg, "l2", pkg.Params(dim=32)), _mesh(pkg, s),
                                 pkg.Params(**WAVES, parallelBuild=pb))
            sh.build(_store(pkg, "dense_vector", x))
            sh.set_query_time_params(pkg.Params(efSearch=60))
            pair.append(sh)
        out[pb] = pair
    return out


def test_mesh_has_8_devices():
    """8 logical shards, as tpu_knn's 8 virtual devices, all on the one CPU
    device; the two-tier mesh is row-major; a CUDA mesh without a card
    raises."""
    m = TM.make_mesh(8, device="cpu")
    assert m.devices.size == JM.make_mesh().devices.size == 8
    assert m.physical_devices() == [torch.device("cpu")] and m.axis_names == (TM.SHARD_AXIS,)
    m2 = TM.make_mesh2(2, 4, device="cpu")
    assert m2.shape == {TM.DCN_AXIS: 2, TM.ICI_AXIS: 4} == dict(JM.make_mesh2(2, 4).shape)
    x = torch.arange(16.0).reshape(8, 2)
    parts = TM.shard_rows(m2, x)
    assert len(parts) == 8 and torch.equal(torch.cat(parts), x)
    assert all(t is x for t in TM.replicate(m, x))
    if not torch.cuda.is_available():
        with pytest.raises(InvalidArgumentError, match="cuda"):
            TM.make_mesh(4)


@pytest.mark.parametrize("rows,s,route", [
    ("continuous", 8, "block"),
    ("integer", 8, "block"),
    ("integer", 2, "twopass"),
])
def test_sharded_exact_matches_single_chip(setup, rows, s, route):
    """Ids equal tpu_knn's sharded_exact_knn, ties of integer-valued rows
    included (both order equal distances by row); the single-device scan
    agrees too."""
    if rows == "continuous":
        x, q, gd, gi = setup
    else:
        rng = np.random.default_rng(12)
        n = 2048 if route == "block" else 32768  # two-pass from 12,288 rows a shard at k=10
        x = rng.integers(-3, 4, (n, 16)).astype(np.float32)
        q = rng.integers(-3, 4, (24, 16)).astype(np.float32)
        gd, gi = _index(tpu_knn, x, "seq_search").knn_query_batch(q, 10)
    jd, ji = _exact(tpu_knn, "l2", "dense_vector", x, q, 10, s)
    pd, pi = _exact(tpu_knn_torch, "l2", "dense_vector", x, q, 10, s)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    if rows == "continuous":
        np.testing.assert_array_equal(pi, gi)
    ix = _index(tpu_knn_torch, x, "seq_search", mesh=s)
    d, i = ix.knn_query_batch(q, 10)
    assert ix.method.last_routes == [route] * s
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, gd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pb", [1, 0], ids=["stacked_waves", "per_shard"])
def test_sharded_hnsw_recall(setup, sharded_hnsw, pb):
    x, q, gd, gi = setup
    j, p = sharded_hnsw[pb]
    _same_graphs(j, p)
    j.dist_comps = p.dist_comps = 0
    jd, ji = j.knn(q, 10)
    pd, pi = p.knn(q, 10)
    rj, rp = _recall(ji, gi), _recall(pi, gi)
    assert rp >= 0.9 and abs(rp - rj) <= 0.005, (rp, rj)
    assert p.dist_comps == j.dist_comps
    assert all(c == {"self_links": 0, "dup_links": 0, "oob_links": 0} for c in p.check_graph())


def test_sharded_exact_sparse():
    """Sparse, corpus_dict-generic: vocab_mark replicated, never split."""
    rng = np.random.default_rng(42)
    pts = _sparse_points(rng, 512, 100, 2, 12)
    out = {}
    for pkg in (tpu_knn, tpu_knn_torch):
        space = _pkg_space(pkg, "cosinesimil_sparse")
        data = space.encode_dataset(_store(pkg, "sparse_vector", pts), row_multiple=64)
        mod = JSH if pkg is tpu_knn else TSH
        out[pkg] = [np.asarray(a) for a in mod.sharded_exact_knn(space, space.encode_queries(pts[:8]), data, 3,
                                                                    _mesh(pkg, 8))]
    (jd, ji), (pd, pi) = out[tpu_knn], out[tpu_knn_torch]
    assert np.array_equal(pi[:, 0], np.arange(1, 9))  # self (1-based)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)


def _sharded_sparse(pkg, pts, params):
    mod = JHS if pkg is tpu_knn else THS
    sh = mod.ShardedHnsw(_pkg_space(pkg, "cosinesimil_sparse"), _mesh(pkg, 8), pkg.Params(params))
    sh.build(_store(pkg, "sparse_vector", pts))
    sh.set_query_time_params(pkg.Params(efSearch=30))
    return sh


def test_sharded_hnsw_sparse():
    """Per-shard HNSW over a sparse corpus (the shared sketch proxy)."""
    rng = np.random.default_rng(43)
    pts = _sparse_points(rng, 256, 80, 2, 10)
    j, p = (_sharded_sparse(pkg, pts, dict(M=6, efConstruction=20, waveSize=16)) for pkg in (tpu_knn, tpu_knn_torch))
    jd, ji = j.knn(pts[:8], 3)
    pd, pi = p.knn(pts[:8], 3)
    assert np.array_equal(pi[:, 0], np.arange(1, 9))  # self hits (1-based ids)
    np.testing.assert_array_equal(pi[:, 0], ji[:, 0])
    np.testing.assert_allclose(pd[:, 0], jd[:, 0], rtol=RTOL, atol=ATOL)


def test_sharded_sparse_uneven_vocab():
    """Shards whose own vocabularies pad to different widths: the build
    unifies them (one vocab floor) and queries score against the right
    vocabulary, in both the HNSW and the exact scan."""
    rng = np.random.default_rng(44)
    pts = []
    for i in range(256):
        base = 1 + i * 7
        pts.append((np.arange(base, base + 25, dtype=np.int64), (0.25 + rng.random(25)).astype(np.float32)))
    j, p = (_sharded_sparse(pkg, pts, dict(M=6, efConstruction=20, waveSize=16)) for pkg in (tpu_knn, tpu_knn_torch))
    pd, pi = p.knn(pts[-8:], 3)
    jd, ji = j.knn(pts[-8:], 3)
    assert np.array_equal(pi[:, 0], np.arange(249, 257))
    np.testing.assert_allclose(pd[:, 0], 0.0, atol=1e-5)
    np.testing.assert_array_equal(pi[:, 0], ji[:, 0])
    space = _pkg_space(tpu_knn_torch, "cosinesimil_sparse")
    data = space.encode_dataset(_store(tpu_knn_torch, "sparse_vector", pts), row_multiple=64)
    d2, i2 = TSH.sharded_exact_knn(space, space.encode_queries(pts[-8:]), data, 3, TM.make_mesh(8, device="cpu"))
    assert np.array_equal(i2.numpy()[:, 0], np.arange(249, 257))


def test_hierarchical_two_tier_merge():
    """[dcn, ici] mesh: the two-tier merge equals the flat merge, tpu_knn's
    two-tier result and the numpy oracle."""
    rng = np.random.default_rng(0)
    n, d, nq, k = 512, 16, 12, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    res = {}
    for pkg, mod in ((tpu_knn, JSH), (tpu_knn_torch, TSH)):
        space = _pkg_space(pkg, "l2", pkg.Params(dim=d))
        data = space.encode_dataset(_store(pkg, "dense_vector", x), row_multiple=64)
        qenc = space.encode_queries(queries)
        m2 = JM.make_mesh2(2, 4) if pkg is tpu_knn else TM.make_mesh2(2, 4, device="cpu")
        res[pkg] = [np.asarray(a) for a in mod.sharded_exact_knn(space, qenc, data, k, _mesh(pkg, 8))
                    + mod.sharded_exact_knn_hier(space, qenc, data, k, m2)]
    d1, i1, d2, i2 = res[tpu_knn_torch]
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    np.testing.assert_array_equal(i2, res[tpu_knn][3])
    np.testing.assert_allclose(d2, res[tpu_knn][2], rtol=RTOL, atol=ATOL)
    full = np.sqrt(((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    np.testing.assert_array_equal(i2, np.argsort(full, 1)[:, :k])


def test_public_api_mesh_routing(tmp_path, setup, sharded_hnsw):
    """Index(..., mesh=N) routes brute_force and hnsw through the sharded
    methods, an int and a Mesh alike, with the Index surface (auto-build,
    query parameters, memory accounting) and save/load; other methods
    raise."""
    x, q, gd, gi = setup
    ex = _index(tpu_knn_torch, x, "brute_force", mesh=8)
    d, i = ex.knn_query_batch(q, 10)
    np.testing.assert_array_equal(i, gi)
    assert isinstance(ex.method, TSH.DistributedSeqSearch) and ex.mesh.size == 8
    ex2 = _index(tpu_knn_torch, x, "seq_search", mesh=TM.make_mesh(8, device="cpu"))
    np.testing.assert_array_equal(ex2.knn_query_batch(q, 10)[1], i)

    idx = _index(tpu_knn_torch, x, "hnsw", mesh=8)
    idx.build_index(tpu_knn_torch.Params(**WAVES))
    idx.set_query_time_params(tpu_knn_torch.Params(efSearch=60))
    d, i = idx.knn_query_batch(q, 10)
    assert isinstance(idx.method, THS.ShardedHnsw)
    assert len(idx.method.graph["level0"]) == 8 and all(bool((l0 >= 0).any()) for l0 in idx.method.graph["level0"])
    np.testing.assert_array_equal(i, sharded_hnsw[1][1].knn(q, 10)[1])
    assert _recall(i, gi) >= 0.9
    assert idx.memory_usage_bytes() > x.nbytes

    p = str(tmp_path / "sharded")
    idx.save(p)
    idx2 = tpu_knn_torch.Index.load(p, device="cpu")
    assert isinstance(idx2.method, THS.ShardedHnsw)
    idx2.set_query_time_params(tpu_knn_torch.Params(efSearch=60))
    d2, i2 = idx2.knn_query_batch(q, 10)
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_allclose(d, d2, rtol=1e-5, atol=1e-5)

    with pytest.raises(InvalidArgumentError, match="distributed"):
        tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=32), method="vptree", mesh=8, device="cpu")
    # an 8-shard state does not restore onto 4 shards
    four = THS.ShardedHnsw(idx.space, TM.make_mesh(4, device="cpu"), tpu_knn_torch.Params(**WAVES))
    with pytest.raises(InvalidArgumentError, match="8 shards"):
        four.restore(idx.store, idx.method.state_arrays())


@pytest.mark.parametrize("writer,reader", [(tpu_knn_torch, tpu_knn), (tpu_knn, tpu_knn_torch)],
                         ids=["port_to_tpu_knn", "tpu_knn_to_port"])
def test_sharded_files_cross_packages(tmp_path, setup, sharded_hnsw, writer, reader):
    """A sharded hnsw file of either package loads in the other with equal
    state arrays and results; mesh_devices 8 in the header. The writer's
    index holds the fixture's built graphs (the CLI's _save_built way)."""
    x, q, _, _ = setup
    src = _index(writer, x, "hnsw", mesh=_mesh(writer, 8))
    src.method = sharded_hnsw[1][0 if writer is tpu_knn else 1]
    src._index_params = writer.Params(**WAVES)
    src.built = True
    p = str(tmp_path / "x")
    src.save(p)
    kw = CPU if reader is tpu_knn_torch else {}
    dst = reader.Index.load(p, **kw)
    assert dst.mesh.devices.size == 8
    _same_graphs(src.method, dst.method)
    src.set_query_time_params(writer.Params(efSearch=60))
    dst.set_query_time_params(reader.Params(efSearch=60))
    d0, i0 = src.knn_query_batch(q, 10)
    d1, i1 = dst.knn_query_batch(q, 10)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(d1, d0, rtol=RTOL, atol=ATOL)


def test_sharded_sparse_shared_proxy(monkeypatch):
    """Sharded sparse builds run on one shared sketch proxy: (a) two shards
    configured by ShardedHnsw._configure_shard draw the same R, tpu_knn's
    R; (b) the stacked build runs on the proxy space with the exact
    refinement; (c) recall@5 against the exact scan within 0.005 of
    tpu_knn's."""
    from tpu_knn.methods.hnsw import Hnsw as JH
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.methods.hnsw import Hnsw as TH

    pts = sparse_like(520, vocab=2000, nnz=24, n_clusters=20, seed=3)
    corpus, q = pts[:512], pts[512:]
    space = _pkg_space(tpu_knn_torch, "cosinesimil_sparse")
    store = _store(tpu_knn_torch, "sparse_vector", corpus)

    # (a) one R for shards of different seeds, equal to tpu_knn's
    halves = []
    for lo, hi in ((0, 256), (256, 512)):
        st = DataStore(DataKind.SPARSE)
        st.add_sparse_batch(corpus[lo:hi], ids=list(range(lo + 1, hi + 1)))
        halves.append(st)
    sh = THS.ShardedHnsw(space, TM.make_mesh(8, device="cpu"), tpu_knn_torch.Params(M=8, efConstruction=40,
                                                                                    waveSize=32))
    vf = sh._global_vocab_floor(store)
    ha, hb = TH(space, tpu_knn_torch.Params(seed=1)), TH(space, tpu_knn_torch.Params(seed=2))
    for h, st in ((ha, halves[0]), (hb, halves[1])):
        sh._configure_shard(h, vf)
        h._prepare(st)  # create_index would drop the construction-only proxy
    assert ha._proxy is not None and hb._proxy is not None
    assert torch.equal(ha._proxy[2], hb._proxy[2])
    assert ha._proxy[1].vecs.shape[1] == hb._proxy[1].vecs.shape[1]
    jsp = _pkg_space(tpu_knn, "cosinesimil_sparse")
    jsh = JHS.ShardedHnsw(jsp, JM.make_mesh(8), tpu_knn.Params(M=8, efConstruction=40, waveSize=32))
    jh = JH(jsp, tpu_knn.Params(seed=1))
    jsh._configure_shard(jh, jsh._global_vocab_floor(_store(tpu_knn, "sparse_vector", corpus)))
    jst = _store(tpu_knn, "sparse_vector", corpus[:256])
    jh._prepare(jst)
    np.testing.assert_array_equal(ha._proxy[2].numpy(), np.asarray(jh._proxy[2]))

    # (b) the stacked build runs on the proxy with exact refinement
    captured = {}
    orig = THS.make_wave_step

    def spy(build_space, *a, **kw):
        captured["space"] = build_space
        captured["exact_space"] = kw.get("exact_space")
        return orig(build_space, *a, **kw)

    monkeypatch.setattr(THS, "make_wave_step", spy)
    sh.build(store)
    assert getattr(captured["space"], "name", "") == "sketch_proxy"
    assert captured["exact_space"] is space

    # (c) recall against the exact scan, beside tpu_knn's
    ex = tpu_knn.Index("cosinesimil_sparse", method="seq_search", data_type="sparse_vector")
    ex.add_sparse_batch(corpus)
    _, gi = ex.knn_query_batch(q, 5)
    jsh.build(_store(tpu_knn, "sparse_vector", corpus))
    sh.set_query_time_params(tpu_knn_torch.Params(efSearch=100))
    jsh.set_query_time_params(tpu_knn.Params(efSearch=100))
    rp, rj = _recall(sh.knn(q, 5)[1], gi), _recall(jsh.knn(q, 5)[1], gi)
    assert rp >= 0.7 and abs(rp - rj) <= 0.005, (rp, rj)


def test_sharded_exact_k_exceeds_shard_rows():
    """k <= corpus size but k > rows a shard: the local top-k clamps to the
    shard and pads before the merge."""
    x = np.random.default_rng(45).standard_normal((100, 16)).astype(np.float32)
    res = {}
    for pkg in (tpu_knn, tpu_knn_torch):
        idx = _index(pkg, x, "seq_search", mesh=_mesh(pkg, 8))
        idx.build_index()
        res[pkg] = idx.knn_query_batch(x[:4], 32)  # 128 padded rows -> 16 a shard
    (jd, ji), (pd, pi) = res[tpu_knn], res[tpu_knn_torch]
    assert pi.shape == (4, 32) and (pi[:, 0] == np.arange(4)).all()
    np.testing.assert_array_equal(pi, ji)
    # a self-distance under the l2 norm identity is the sqrt of an f32
    # cancellation (0 or ~1e-3) in either package: compared apart
    assert (pd[:, 0] < 1e-2).all() and (jd[:, 0] < 1e-2).all()
    np.testing.assert_allclose(pd[:, 1:], jd[:, 1:], rtol=RTOL, atol=ATOL)
    gd, gi = _index(tpu_knn_torch, x, "seq_search").knn_query_batch(x[:4], 32)
    np.testing.assert_array_equal(pi, gi)


def test_sharded_hnsw_query_param_validation(setup, sharded_hnsw):
    """A typo in the query-time parameters raises, efSearch sets, and a
    mesh query counts its distance computations as tpu_knn's does."""
    x = setup[0]
    dc = []
    for pkg, sh in zip((tpu_knn, tpu_knn_torch), sharded_hnsw[1]):
        idx = _index(pkg, x, "hnsw", mesh=_mesh(pkg, 8))
        idx.method, idx.built = sh, True  # the fixture's graphs
        with pytest.raises(Exception, match="[Uu]nknown|unused"):
            idx.set_query_time_params(pkg.Params(efSaerch=200))  # a typo raises
        idx.set_query_time_params(pkg.Params(efSearch=40))
        assert idx.method.ef_search == 40
        idx.method.dist_comps = 0
        idx.knn_query_batch(x[:4], 3)
        dc.append(idx.method.dist_comps)
        idx.set_query_time_params(pkg.Params(efSearch=60))  # the fixture's setting
    assert dc[1] > 0 and dc[1] == dc[0]


def test_sharded_range_matches_single_device(setup):
    """Per-shard radius scans merged: the id sets of the single-device
    range and of tpu_knn's sharded range, distances within rtol 5e-3."""
    x, q, gd, gi = setup
    radius = float(np.median(np.asarray(gd)[:, 9]))
    res_s = _index(tpu_knn_torch, x, "seq_search").range_query_batch(q, radius)
    sharded = _index(tpu_knn_torch, x, "seq_search", mesh=8)
    res_m = sharded.range_query_batch(q, radius)
    res_j = _index(tpu_knn, x, "seq_search", mesh=8).range_query_batch(q, radius)
    assert len(res_s) == len(res_m) == len(res_j) == len(q)
    for a, b, c in zip(res_s, res_m, res_j):
        np.testing.assert_array_equal(np.sort(a.ids), np.sort(b.ids))
        np.testing.assert_array_equal(np.sort(c.ids), np.sort(b.ids))
        np.testing.assert_allclose(np.sort(b.dists), np.sort(c.dists), rtol=RTOL, atol=ATOL)
    assert all(len(r.ids) == 0 for r in sharded.range_query_batch(q, 1e-6))


def test_sharded_nnd_build(setup):
    """buildAlgo=nndescent under a mesh builds every shard by NN-descent,
    with tpu_knn's neighbour sets and recall; "auto" resolves per shard
    size: with buildAlgoAutoN at 128, 256 rows a shard route to NN-descent
    and give the same graphs. 512 of setup's rows on 2 shards (tpu_knn's
    NN-descent compiles per shard: ~5 s each)."""
    x, q = setup[0][:512], setup[1]
    _, gi = _index(tpu_knn_torch, x, "seq_search").knn_query_batch(q, 10)
    rec, meth = {}, {}
    for pkg in (tpu_knn, tpu_knn_torch):
        idx = _index(pkg, x, "hnsw", mesh=2)
        idx.build_index(pkg.Params(M=8, efConstruction=60, buildAlgo="nndescent"))
        idx.set_query_time_params(pkg.Params(efSearch=60))
        rec[pkg] = _recall(idx.knn_query_batch(q, 10)[1], gi)
        meth[pkg] = idx.method
    assert meth[tpu_knn_torch].build_algo == "nndescent"
    _same_graphs(meth[tpu_knn], meth[tpu_knn_torch])
    assert rec[tpu_knn_torch] >= 0.9 and abs(rec[tpu_knn_torch] - rec[tpu_knn]) <= 0.005

    auto = _index(tpu_knn_torch, x, "hnsw", mesh=2)
    auto.build_index(tpu_knn_torch.Params(M=8, efConstruction=60, buildAlgoAutoN=128))
    _same_graphs(meth[tpu_knn_torch], auto.method)
