"""NAPP (napp / pivot_neighb_invindx) in the port (device="cpu"), held
against tpu_knn on the same seeded numpy inputs: dense rows (2,000 x 16,
l2) and sparse_like rows (1,000, vocab 2,000, 16 terms a row,
cosinesimil_sparse).

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties. The pivot prefixes may differ only where two pivot
distances tie within that tolerance. ScanCount is exact integer counting
in both packages, so dist_comps must be equal as integers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered, sparse_like  # noqa: E402
from tpu_knn_torch.methods import napp as TN  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
PKGS = (tpu_knn, tpu_knn_torch)
BUILD = {"numPivot": 64, "numPrefix": 8, "seed": 3}


def _data(kind: str):
    """(space, data_type, corpus, queries) of each shape."""
    if kind == "dense":
        x = clustered(2040, 16, n_clusters=40, seed=7)
        return "l2", "dense_vector", x[:2000], x[2000:]
    pts = sparse_like(1040, vocab=2_000, nnz=16, n_clusters=12, seed=8)
    return "cosinesimil_sparse", "sparse_vector", pts[:1000], pts[1000:]


def _index(pkg, kind, method="napp", build=BUILD):
    space, dt, x, q = _data(kind)
    idx = pkg.Index(space, pkg.Params({"dim": 16} if kind == "dense" else {}), method=method, data_type=dt,
                    **(CPU if pkg is tpu_knn_torch else {}))
    (idx.add_dense_batch if kind == "dense" else idx.add_sparse_batch)(x)
    if build is not None:
        idx.build_index(build)
    return idx, q


def _assert_same_knn(ref, got):
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, -1], rtol=RTOL, atol=ATOL), (r, c)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_pivots_and_prefix_equal_tpu_knn(kind):
    """The same pivots from np_rng(seed), and the per-object prefix (the
    numPrefix closest pivots in lax.top_k's order) equal except where two
    pivot distances tie within the tolerance."""
    (j, _), (t, _) = _index(tpu_knn, kind), _index(tpu_knn_torch, kind)
    np.testing.assert_array_equal(t.method._pivot_rows.numpy(), np.asarray(j.method._pivot_rows))
    pj, pt = np.asarray(j.method._prefix), t.method._prefix.numpy()
    assert pj.shape == pt.shape and t.method._chunk == j.method._chunk
    n = t.method.data.count
    assert (pt[n:] == -1).all()
    bad = np.nonzero((pj != pt).any(axis=1))[0]
    assert len(bad) <= n // 100
    if len(bad):
        space = t.space
        pts = space.store_as_query_points(t.store)[bad]
        d = space.block(space.encode_queries(pts), TN._gather_xc(space, t.method.data, t.method._pivot_rows))
        d = d.numpy()
        for r, row in enumerate(bad):
            np.testing.assert_allclose(d[r, pt[row]], d[r, pj[row]], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("alg,skip", [("scan", False), ("gather", False), ("scan", True)])
@pytest.mark.parametrize("min_times", [1, 2, 4])
def test_knn_matches_tpu_knn(kind, alg, skip, min_times):
    """kNN at k=10 on both invProcAlg routes and with skipChecking: ids
    equal except on ties, distances within the tolerance (skipChecking
    ranks by -count, exactly), dist_comps equal as integers."""
    (j, q), (t, _) = _index(tpu_knn, kind), _index(tpu_knn_torch, kind)
    qp = {"invProcAlg": alg, "skipChecking": skip, "minTimes": min_times, "numPrefixSearch": 12}
    for idx in (j, t):
        idx.set_query_time_params(qp)
        idx.method.dist_comps = 0
    ref, got = j.knn_query_batch(q, 10), t.knn_query_batch(q, 10)
    if skip:
        np.testing.assert_array_equal(got[0], ref[0])
    _assert_same_knn(ref, got)
    assert t.method.dist_comps == j.method.dist_comps > 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_range_with_every_candidate_equals_exact(kind):
    """numPrefixSearch = numPivot and minTimes=1 make every object a
    candidate, so NAPP's range equals the exact seq_search range, id set
    for id set; at the defaults it is a subset, equal to tpu_knn's."""
    (t, q), (ex, _) = _index(tpu_knn_torch, kind), _index(tpu_knn_torch, kind, "seq_search", None)
    d, _ = ex.knn_query_batch(q, 10)
    radius = float(np.median(d[:, 4]))
    want = ex.range_query_batch(q, radius)
    t.set_query_time_params({"numPrefixSearch": 64, "minTimes": 1})
    for g, w in zip(t.range_query_batch(q, radius), want):
        assert set(g.ids) == set(w.ids)
        assert np.all(np.diff(g.dists) >= 0) and g.ids.dtype == np.int32
    j, _ = _index(tpu_knn, kind)
    t.set_query_time_params(None)
    for idx in (j, t):
        idx.method.dist_comps = 0
    rj, rt = j.range_query_batch(q, radius), t.range_query_batch(q, radius)
    assert t.method.dist_comps == j.method.dist_comps
    for a, b, w in zip(rj, rt, want):
        assert set(b.ids) <= set(w.ids)
        ma, mb = dict(zip(a.ids, a.dists)), dict(zip(b.ids, b.dists))
        for i in set(ma) ^ set(mb):
            assert abs(ma.get(i, mb.get(i)) - radius) <= RTOL * radius + ATOL


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fused_scan_does_not_depend_on_its_chunk(kind):
    """The fused kNN scan streams over any chunk width (ragged last step
    included) with the same bits: the card may scan wider than the 256 rows
    that plan a sparse index."""
    t, q = _index(tpu_knn_torch, kind)
    m = t.method
    qenc = t.space.encode_queries(q)
    outs = [TN._napp_knn(t.space, qenc, m.data, m._pivot_rows, m._prefix, 10, chunk, 2, False, 8)
            for chunk in (256, 384, 1000, 4096)]
    for d, ids, nd in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(ids, outs[0][1]) and torch.equal(nd, outs[0][2])


def test_plan_chunk_is_tpu_knn_s():
    """NAPP plans with tpu_knn's chunk whatever the port's own: 256 rows
    for a sparse space (the port's preferred chunk is 4080 on the card),
    8192 for a dense one."""
    sp = tpu_knn_torch.core.registry.create_space("cosinesimil_sparse", None, device="cpu")
    dn = tpu_knn_torch.core.registry.create_space("l2", {"dim": 4}, device="cpu")
    assert TN.plan_chunk(sp) == 256 and TN.plan_chunk(dn) == 8192
    sp.device = torch.device("cuda")  # the chunk a card would prefer, without a card
    assert sp.preferred_chunk == 4080 and TN.plan_chunk(sp) == 256


def test_gather_covers_the_fused_scan_at_full_budget():
    """With a budget that covers every candidate, the gather route returns
    the fused scan's results; a tight budget still returns results, and
    fewer candidates (harsher minTimes) mean fewer dist_comps."""
    t, q = _index(tpu_knn_torch, "sparse")
    out = {}
    for alg, frac in (("scan", 0.05), ("gather", 4.0)):
        t.set_query_time_params({"invProcAlg": alg, "dbScanFrac": frac, "minTimes": 2})
        out[alg] = t.knn_query_batch(q, 5)
    np.testing.assert_array_equal(out["scan"][1], out["gather"][1])
    np.testing.assert_allclose(out["scan"][0], out["gather"][0], rtol=RTOL, atol=ATOL)
    t.set_query_time_params({"invProcAlg": "gather", "dbScanFrac": 0.02})
    assert (t.knn_query_batch(q, 5)[1][:, 0] >= 0).any()
    t.set_query_time_params({"invProcAlg": "scan", "minTimes": 2})
    t.method.dist_comps = 0
    t.knn_query_batch(q, 5)
    loose = t.method.dist_comps
    t.set_query_time_params({"minTimes": 4})
    t.method.dist_comps = 0
    t.knn_query_batch(q, 5)
    assert t.method.dist_comps <= loose


def test_parameter_errors_equal_tpu_knn(tmp_path):
    """An unknown invProcAlg or parameter and an out-of-range pivotFile
    raise tpu_knn's classes; a pivotFile gives its pivots; both registry
    names build the same index."""
    f = tmp_path / "pivots.txt"
    f.write_text("\n".join(str(i) for i in range(0, 640, 10)))
    bad = tmp_path / "bad.txt"
    bad.write_text("1\n5000\n")
    for pkg in PKGS:
        idx, q = _index(pkg, "dense", build={"numPivot": 64, "numPrefix": 8, "pivotFile": str(f)})
        np.testing.assert_array_equal(np.asarray(idx.method._pivot_rows.cpu() if pkg is tpu_knn_torch
                                                 else idx.method._pivot_rows), np.arange(0, 640, 10))
        with pytest.raises(pkg.InvalidArgumentError):
            idx.set_query_time_params({"invProcAlg": "wand"})
        with pytest.raises(pkg.InvalidArgumentError):
            idx.set_query_time_params({"noSuchParam": 1})
        with pytest.raises(pkg.InvalidArgumentError):
            _index(pkg, "dense", build={"numPivot": 64, "pivotFile": str(bad)})
        with pytest.raises(pkg.InvalidArgumentError):
            _index(pkg, "dense", build={"numPivot": 64, "noSuchParam": 2})
    a, q = _index(tpu_knn_torch, "dense", method="napp")
    b, _ = _index(tpu_knn_torch, "dense", method="pivot_neighb_invindx")
    assert type(a.method) is type(b.method)
    for x, y in zip(a.knn_query_batch(q, 5), b.knn_query_batch(q, 5)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_files_cross(tmp_path, kind):
    """An index either package saves (format v3, the pivots and prefix as
    state) loads in the other and answers the same; an empty index raises
    IndexNotBuiltError at query time in both."""
    (j, q), (t, _) = _index(tpu_knn, kind), _index(tpu_knn_torch, kind)
    ref = t.knn_query_batch(q, 5)
    _assert_same_knn(j.knn_query_batch(q, 5), ref)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn), (t, tpu_knn_torch)):
        path = str(tmp_path / f"{reader.__name__}")
        src.save(path, save_data=False)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        np.testing.assert_array_equal(np.asarray(back.method._prefix.cpu() if reader is tpu_knn_torch
                                                 else back.method._prefix),
                                      np.asarray(src.method._prefix.cpu() if src is t else src.method._prefix))
        got = back.knn_query_batch(q, 5)
        if src is t and reader is tpu_knn_torch:
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
        else:
            _assert_same_knn(ref, got)
    for pkg in PKGS:
        e = pkg.Index("l2", pkg.Params({"dim": 4}), method="napp", **(CPU if pkg is tpu_knn_torch else {}))
        with pytest.raises(pkg.IndexNotBuiltError):
            e.knn_query_batch(np.zeros((2, 4), np.float32), 3)
