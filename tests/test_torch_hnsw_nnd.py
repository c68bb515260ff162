"""The NN-descent build of HNSW in the port (buildAlgo="nndescent", and
"auto" from buildAlgoAutoN rows up; device="cpu") against tpu_knn's on the
same data and seed: the whole build, its modes, its routing and fallback,
graphs carried across in both directions, and tests/test_nndescent.py's
cases.

Level-0 rows hold tpu_knn's neighbour sets in at least 0.99 of rows (the
share found is printed); recall@10 at efSearch=50 is within 0.02 of
tpu_knn's and at least 0.9. Sizes are those of tests/test_nndescent.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch import Index, Params  # noqa: E402
from tpu_knn_torch.eval.datasets import sift_like  # noqa: E402
from tpu_knn_torch.ops import nndescent as TN  # noqa: E402

N, NQ, K, DIM = 1024, 128, 10, 32
CPU = {"device": "cpu"}
NND = dict(M=8, efConstruction=60, buildAlgo="nndescent", nndChunk=1024, nndIters=5, nndK=24, nndKrev=8)
ZERO = {"self_links": 0, "dup_links": 0, "oob_links": 0}


def _index(pkg, space, x, build=None, method="hnsw", **kw):
    kw = dict(kw, **(CPU if pkg is tpu_knn_torch else {}))
    if x.dtype == np.uint8:
        idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method, "dense_uint8_vector", "int", **kw)
        idx.add_uint8_batch(x)
    else:
        idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method=method, **kw)
        idx.add_dense_batch(x)
    if build is not None:
        idx.build_index(pkg.Params(build))
    return idx


def _recall(ids, gold):
    return float(np.mean([len(set(a[a >= 0]) & set(b)) / K for a, b in zip(np.asarray(ids), gold)]))


def _level0(idx, n=N):
    return np.asarray(idx.method.graph["level0"])[:n]


def _set_share(a, b):
    return float(np.mean([set(r) == set(s) for r, s in zip(a, b)]))


@pytest.fixture(scope="module")
def data():
    pts = sift_like(N + NQ, DIM, seed=3)
    return pts[:N], pts[N:]


@pytest.fixture(scope="module")
def built(data):
    """The l2 NN-descent build in both packages."""
    corpus, _ = data
    return _index(tpu_knn, "l2", corpus, NND), _index(tpu_knn_torch, "l2", corpus, NND)


def _gold(space, x, q):
    return _index(tpu_knn_torch, space, x, method="seq_search").knn_query_batch(q, K)[1]


def _sift_u8():
    """tests/test_nndescent.py's clustered uint8 descriptors."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 200, size=(16, 128))
    pts = np.clip(centers[rng.integers(0, 16, N + NQ)] + rng.normal(0, 12, (N + NQ, 128)), 0, 255)
    return pts.astype(np.uint8)


def _check_against_tpu_knn(jidx, tidx, x, q, space, label):
    share = _set_share(_level0(jidx), _level0(tidx))
    print(f"{label}: level-0 rows with tpu_knn's neighbour set: {share:.4f}")
    # found 1.0 on x86-64 for every case of this file
    assert share >= 0.99
    assert tidx.method.check_graph() == ZERO
    assert [tuple(u.shape) for u in jidx.method._upper] == [tuple(u.shape) for u in tidx.method._upper]
    gold = _gold(space, x, q)
    jidx.set_query_time_params(tpu_knn.Params(efSearch=50))
    tidx.set_query_time_params(Params(efSearch=50))
    rj, rt = _recall(jidx.knn_query_batch(q, K)[1], gold), _recall(tidx.knn_query_batch(q, K)[1], gold)
    print(f"{label}: recall@{K} at efSearch=50, tpu_knn {rj:.4f}, port {rt:.4f}")
    assert rt >= 0.9 and abs(rt - rj) <= 0.02, (rj, rt)


# ---------------- the whole build against tpu_knn's ----------------


def test_l2_build_matches_tpu_knn(built, data):
    jidx, tidx = built
    np.testing.assert_array_equal(tidx.method.levels, jidx.method.levels)
    np.testing.assert_array_equal(tidx.method.order, jidx.method.order)
    assert tidx.method._qenc_all is None and tidx.method.graph["level0"].dtype == torch.int32
    for ju, tu in zip(jidx.method._upper, tidx.method._upper):
        assert _set_share(np.asarray(ju), tu.numpy()) >= 0.99
    _check_against_tpu_knn(jidx, tidx, data[0], data[1], "l2", "l2")


def test_self_findability(built, data):
    """Every corpus point finds itself at low ef (in-degree starvation
    check of tests/test_nndescent.py)."""
    _, tidx = built
    tidx.set_query_time_params(Params(efSearch=20))
    _, ids = tidx.knn_query_batch(data[0][:256], 1)
    assert np.mean(ids[:, 0] == np.arange(256)) >= 0.99


@pytest.mark.parametrize("mode", [dict(nndRevMode="slots"), dict(nndPolishStore=0)])
def test_build_modes_match_tpu_knn(data, mode):
    """The first-come reverse slots and the exact polish beam
    (nndPolishStore=1 is the default of the other tests; the f32 scoring
    copy is in tests/test_torch_nndescent.py)."""
    corpus, q = data
    jidx, tidx = (_index(pkg, "l2", corpus, dict(NND, **mode)) for pkg in (tpu_knn, tpu_knn_torch))
    _check_against_tpu_knn(jidx, tidx, corpus, q, "l2", str(mode))


def test_polish_store_is_gated_and_exact(built, data):
    """nndPolishStore=1 (the default) explores the polish beam on an int8
    store where _cstore_ok allows it; the merged distances it hands the
    selection are exact, so the graph matches tpu_knn's (above)."""
    _, tidx = built
    assert tidx.method.nnd_polish_store == 1 and tidx.method._cstore_ok()
    sift = _index(tpu_knn_torch, "l2sqr_sift", _sift_u8()[:300], dict(NND, nndChunk=256))
    assert not sift.method._cstore_ok()  # int8 rows: the polish explores on the corpus rows


# ---------------- same seed, same graph; routing; fallback ----------------


def test_same_seed_same_graph(built, data):
    _, a = built
    b = _index(tpu_knn_torch, "l2", data[0], NND)
    assert torch.equal(a.method.graph["level0"], b.method.graph["level0"])
    assert len(a.method._upper) == len(b.method._upper) > 0
    for ua, ub in zip(a.method._upper, b.method._upper):
        assert torch.equal(ua, ub)
    da, ia = a.knn_query_batch(data[1], 5)
    db, ib = b.knn_query_batch(data[1], 5)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


def test_auto_threshold_routes_as_tpu_knn(built, data):
    """buildAlgo="auto" (the default) builds the NN-descent graph from
    buildAlgoAutoN rows up and the wave graph below, each equal to the
    explicitly requested build."""
    corpus, _ = data
    _, nnd = built
    auto = {k: v for k, v in NND.items() if k != "buildAlgo"}
    at_n = _index(tpu_knn_torch, "l2", corpus, dict(auto, buildAlgoAutoN=N))
    assert torch.equal(at_n.method.graph["level0"], nnd.method.graph["level0"])
    waves = _index(tpu_knn_torch, "l2", corpus, dict(auto, waveSize=512, buildAlgo="waves"))
    above = _index(tpu_knn_torch, "l2", corpus, dict(auto, waveSize=512, buildAlgoAutoN=N + 1))
    assert torch.equal(above.method.graph["level0"], waves.method.graph["level0"])
    assert not torch.equal(above.method.graph["level0"], nnd.method.graph["level0"])
    assert above.method._qenc_all is None and at_n.method._qenc_all is None


def test_fallback_to_waves_warns(data):
    """l1 has no affine pass-1 form, so it is not eligible for NN-descent:
    buildAlgo="nndescent" falls back to the wave build with tpu_knn's
    WARNING (tests/test_nndescent.py's fallback case)."""
    from tpu_knn_torch.utils import logging as L

    corpus, q = data
    idx = _index(tpu_knn_torch, "l1", corpus)
    lines = []
    L.LOGGER.set_custom(lambda level, msg: lines.append((level, msg)))
    try:
        idx.build_index(Params(M=8, efConstruction=40, buildAlgo="nndescent", waveSize=512))
    finally:
        L.LOGGER.set_stderr()
    assert any(lv == "WARNING" and "falling back to waves" in msg for lv, msg in lines)
    assert not idx.method._nnd_eligible() and not idx.method._will_use_nnd(N)
    assert idx.method.check_graph() == ZERO and idx.method._qenc_all is None
    idx.set_query_time_params(Params(efSearch=30))
    _, ids = idx.knn_query_batch(q[:16], K)
    assert ids.shape == (16, K) and np.all(ids[:, 0] >= 0)


def test_progress_and_profile_lines(data):
    """print_progress logs each descent sweep's updates; nndProfile=1 logs
    every phase mark, as tpu_knn does."""
    from tpu_knn_torch.utils import logging as L

    lines = []
    L.LOGGER.set_custom(lambda level, msg: lines.append(msg))
    try:
        idx = _index(tpu_knn_torch, "l2", data[0][:600])
        idx.build_index(Params(dict(NND, nndChunk=256, nndProfile=1)))
    finally:
        L.LOGGER.set_stderr()
    marks = [ln.split("phase ")[1].split(":")[0] for ln in lines if ln.startswith("hnsw nnd phase ")]
    assert marks[:3] == ["init_exact", "descent_sweeps", "final_exact"]
    assert {"pl_prune", "pl_rev", "pl_shrink", "link0", "uppers", "polish0", "link1"} <= set(marks)
    assert any(ln.startswith("hnsw nnd sweep 1: ") for ln in lines)


# ---------------- graphs carried across ----------------


def test_graphs_cross_between_the_packages(built, data, tmp_path):
    """The port's NN-descent graph loads and searches in tpu_knn, and
    tpu_knn's in the port, with the same answers."""
    corpus, q = data
    jidx, tidx = built
    for name, src, back in (("port", tidx, None), ("tpu_knn", jidx, None)):
        path = str(tmp_path / name)
        src.save(path)
        if src is tidx:
            back = tpu_knn.Index.load(path)
            back.set_query_time_params(tpu_knn.Params(efSearch=50))
            src.set_query_time_params(Params(efSearch=50))
        else:
            back = Index.load(path, **CPU)
            back.set_query_time_params(Params(efSearch=50))
            src.set_query_time_params(tpu_knn.Params(efSearch=50))
        np.testing.assert_array_equal(_level0(back), _level0(src))
        (d1, i1), (d2, i2) = src.knn_query_batch(q, K), back.knn_query_batch(q, K)
        assert np.mean(i1 == i2) >= 0.99
        np.testing.assert_allclose(d2[i1 == i2], d1[i1 == i2], rtol=5e-3, atol=1e-5)


def test_reachability_repaired_from_the_entry(built):
    """A refinement-built graph has no insertion-time reachability: every
    node is reachable from the entry after the build."""
    _, tidx = built
    reach = TN._reach_from_host(tidx.method.graph["level0"].numpy(), tidx.method._entry)
    assert reach[:N].all()
