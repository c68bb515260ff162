"""VP-tree in the port (device="cpu"): the VP-tree tests of
tests/test_methods.py replayed on the port, and the tree arrays, both query
routes, range, the autotuner and files held against tpu_knn on the same
seeded inputs.

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties. The tree's split distances are f32 scores whose sums may
run in another order than XLA's, so the medians agree within 1e-5
relative and the integer tree arrays exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch import Index, Params  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered, sparse_like  # noqa: E402

CPU = {"device": "cpu"}
RTOL, ATOL = 5e-3, 1e-5
TREE = ("pivot_pos", "medians", "leaf_members", "leaf_of", "leaf_count")


def _recall(approx_ids, exact_ids):
    k = exact_ids.shape[1]
    return np.mean([len(set(a[a >= 0]) & set(b)) / k for a, b in zip(approx_ids, exact_ids)])


@pytest.fixture()
def dense_pair(rng):
    x = rng.standard_normal((200, 12)).astype(np.float32)
    q = x[:25]
    ex = Index("l2", Params(dim=12), method="seq_search", **CPU)
    ex.add_dense_batch(x)
    ed, eids = ex.knn_query_batch(q, 5)
    return x, q, ed, eids


def _vp(x, build=None, pkg=tpu_knn_torch, space="l2"):
    idx = pkg.Index(space, pkg.Params(dim=x.shape[1]), method="vptree", **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_dense_batch(x)
    idx.build_index(pkg.Params(build or dict(bucketSize=20)))
    return idx


def test_vptree_exact_with_default_pruner(dense_pair):
    x, q, ed, eids = dense_pair
    d, ids = _vp(x).knn_query_batch(q, 5)
    assert _recall(ids, eids) == 1.0  # alpha=1, exp=1: the true triangle inequality
    assert np.allclose(np.where(np.isfinite(d), d, 0), np.where(np.isfinite(ed), ed, 0), atol=5e-3)


def test_vptree_alpha_tradeoff(dense_pair):
    x, q, ed, eids = dense_pair
    idx = _vp(x)
    idx.set_query_time_params(Params(alphaLeft=1.0, alphaRight=1.0))
    idx.knn_query_batch(q, 5)
    dc_exact = idx.method.dist_comps
    idx.method.dist_comps = 0
    idx.set_query_time_params(Params(alphaLeft=64.0, alphaRight=64.0))
    d, ids = idx.knn_query_batch(q, 5)
    assert idx.method.dist_comps <= dc_exact
    assert _recall(ids, eids) >= 0.3


def test_vptree_max_leaves(dense_pair):
    x, q, ed, eids = dense_pair
    idx = _vp(x)
    idx.set_query_time_params(Params(maxLeavesToVisit=1))
    d, ids = idx.knn_query_batch(q, 5)
    assert (ids >= -1).all()


def test_vptree_gathered_matches_masked(dense_pair):
    """A finite maxLeavesToVisit takes the gathered route; the masked scan
    visits the same capped leaf set, so results and distance counts agree."""
    x, q, ed, eids = dense_pair
    idx = _vp(x)
    for ml in (2, 6):
        idx.set_query_time_params(Params(maxLeavesToVisit=ml))
        assert ml < idx.method._tree["leaf_members"].shape[0]
        d_g, i_g = idx.knn_query_batch(q, 5)
        dc_g = idx.method.dist_comps
        idx.method.dist_comps = 0
        try:
            idx.method.gather_traversal = False
            d_m, i_m = idx.knn_query_batch(q, 5)
        finally:
            idx.method.gather_traversal = True
        dc_m = idx.method.dist_comps
        idx.method.dist_comps = 0
        np.testing.assert_array_equal(i_g, i_m)
        np.testing.assert_allclose(np.where(np.isfinite(d_g), d_g, 0), np.where(np.isfinite(d_m), d_m, 0), atol=5e-3)
        assert dc_g == dc_m > 0


def test_vptree_range(dense_pair):
    x, q, ed, eids = dense_pair
    idx = Index("l2", Params(dim=12), method="vptree", **CPU)
    idx.add_dense_batch(x)
    res = idx.range_query(q[0], radius=float(ed[0, 3]))
    assert set(eids[0, :3]).issubset(set(res.ids))
    assert (res.dists <= ed[0, 3] + 1e-5).all()


def test_vptree_autotune(dense_pair):
    x, q, ed, eids = dense_pair
    idx = _vp(x, dict(bucketSize=20, desiredRecall=0.95, tuneK=5, tuneQty=30))
    assert idx.method.alpha_left >= 1.0


def _pair(x, build, space="l2"):
    return _vp(x, build, tpu_knn, space), _vp(x, build, tpu_knn_torch, space)


def _tree(idx):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in idx.method._tree.items()}


@pytest.mark.parametrize("n,bucket", [(3000, 50), (777, 7)])
def test_tree_arrays_equal_tpu_knn(n, bucket):
    x = clustered(n, 16, n_clusters=30, seed=2)
    a, b = _pair(x, dict(bucketSize=bucket, seed=4))
    ta, tb = _tree(a), _tree(b)
    assert (a.method.depth, a.method.leaf_cap, a.method._chunk) == (b.method.depth, b.method.leaf_cap, b.method._chunk)
    for k in TREE:
        if k == "medians":
            np.testing.assert_allclose(tb[k], ta[k], rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(tb[k], ta[k])


#: a query that is a stored point scores itself as sqrt of an f32
#: cancellation under the l2 norm identity, 0 or ~1e-3 in either package
SELF_FLOOR = 2e-3


def _same_knn(ref, got):
    (d1, i1), (d2, i2) = ref, got
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1) & ~((np.abs(d1) <= SELF_FLOOR) & (np.abs(d2) <= SELF_FLOOR))
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert np.isclose(d2[r, c], d1[r, c], rtol=RTOL, atol=ATOL), (r, c)


@pytest.mark.parametrize("params", [
    {},  # the exact pruner, masked route
    {"alphaLeft": 2.0, "alphaRight": 2.0},  # masked route, stretched
    {"alphaLeft": 2.0, "alphaRight": 2.0, "maxLeavesToVisit": 4},  # gathered route
    {"alphaLeft": 3.0, "alphaRight": 1.5, "expLeft": 2.0, "maxLeavesToVisit": 9},
])
def test_knn_routes_equal_tpu_knn(params):
    x = clustered(3040, 16, n_clusters=30, seed=3)
    a, b = _pair(x[:3000], dict(bucketSize=40, seed=1))
    q = x[3000:]
    for idx, pkg in ((a, tpu_knn), (b, tpu_knn_torch)):
        idx.set_query_time_params(pkg.Params(params))
        idx.method.dist_comps = 0
    ra, rb = a.knn_query_batch(q, 10), b.knn_query_batch(q, 10)
    _same_knn(ra, rb)
    assert a.method.dist_comps == b.method.dist_comps


def test_range_equals_tpu_knn():
    x = clustered(2040, 16, n_clusters=30, seed=5)
    a, b = _pair(x[:2000], dict(bucketSize=30))
    q = x[2000:]
    radius = float(np.median(a.knn_query_batch(q, 10)[0][:, -1]))
    for alpha in (1.0, 2.0):
        for idx, pkg in ((a, tpu_knn), (b, tpu_knn_torch)):
            idx.set_query_time_params(pkg.Params(alphaLeft=alpha, alphaRight=alpha))
        ra, rb = a.range_query_batch(q, radius), b.range_query_batch(q, radius)
        for x1, x2 in zip(ra, rb):
            assert set(x1.ids.tolist()) == set(x2.ids.tolist())
            np.testing.assert_allclose(np.sort(x2.dists), np.sort(x1.dists), rtol=RTOL, atol=ATOL)


def test_autotuner_alphas_equal_tpu_knn():
    x = clustered(1500, 16, n_clusters=20, seed=6)
    build = dict(bucketSize=25, desiredRecall=0.9, tuneK=5, tuneQty=40, minExp=1, maxExp=2)
    a, b = _pair(x, build)
    for key in ("alpha_left", "alpha_right", "exp_left", "exp_right"):
        assert getattr(a.method, key) == getattr(b.method, key), key


def test_degenerate_single_leaf():
    x = clustered(40, 8, n_clusters=4, seed=7)
    a, b = _pair(x, dict(bucketSize=100))
    assert b.method._tree["pivot_pos"].shape[0] == 0
    _same_knn(a.knn_query_batch(x[:5], 50), b.knn_query_batch(x[:5], 50))
    r1, r2 = a.range_query_batch(x[:3], 3.0), b.range_query_batch(x[:3], 3.0)
    assert [set(r.ids.tolist()) for r in r1] == [set(r.ids.tolist()) for r in r2]


def test_files_cross_both_ways(tmp_path):
    x = clustered(1200, 16, n_clusters=20, seed=8)
    q = x[:20]
    for src_pkg, dst_pkg in ((tpu_knn, tpu_knn_torch), (tpu_knn_torch, tpu_knn)):
        src = _vp(x, dict(bucketSize=30), src_pkg)
        src.set_query_time_params(src_pkg.Params(maxLeavesToVisit=5))
        p = str(tmp_path / f"vp_{src_pkg.__name__}")
        src.save(p)
        back = dst_pkg.Index.load(p, **(CPU if dst_pkg is tpu_knn_torch else {}))
        back.set_query_time_params(dst_pkg.Params(maxLeavesToVisit=5))
        tb = back.method._tree
        for k in TREE:
            np.testing.assert_array_equal(np.asarray(tb[k]) if not isinstance(tb[k], torch.Tensor) else tb[k].numpy(),
                                          _tree(src)[k])
        _same_knn(src.knn_query_batch(q, 5), back.knn_query_batch(q, 5))


def test_sparse_and_string_spaces():
    """The tree over a sparse space (the densified query tables on the
    scan and gather paths) and over leven, against tpu_knn."""
    pts = sparse_like(640, vocab=500, nnz=12, n_clusters=8, seed=9)
    res = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, CPU)):
        idx = pkg.Index("cosinesimil_sparse", method="vptree", data_type="sparse_vector", **kw)
        idx.add_sparse_batch(pts[:600])
        idx.build_index(pkg.Params(bucketSize=30))
        out = [idx.knn_query_batch(pts[600:], 5)]
        idx.set_query_time_params(pkg.Params(alphaLeft=2.0, alphaRight=2.0, maxLeavesToVisit=3))
        out.append(idx.knn_query_batch(pts[600:], 5))
        res.append(out)
    for ra, rb in zip(*res):
        _same_knn(ra, rb)
    rng = np.random.default_rng(10)
    strs = [bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(rng.integers(3, 12)))]) for _ in range(300)]
    res = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, CPU)):
        idx = pkg.Index("leven", method="vptree", data_type="object_as_string", dist_type="int", **kw)
        idx.add_string_batch(strs)
        idx.build_index(pkg.Params(bucketSize=20))
        res.append((idx.knn_query_batch(strs[:16], 5), _tree(idx)))
    np.testing.assert_array_equal(res[1][0][0], res[0][0][0])
    np.testing.assert_array_equal(res[1][0][1], res[0][0][1])
    for k in TREE:
        np.testing.assert_array_equal(res[1][1][k], res[0][1][k])
