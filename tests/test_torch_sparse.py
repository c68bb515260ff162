"""The sparse spaces in the port (device="cpu"), held against tpu_knn on
the same seeded numpy inputs and against a float64 oracle of the reference
formulas: the padded-CSR encode, the primitives of ops/sparse.py, every
name's block, gathered and pair scoring, the exact scan (kNN, range,
async, ragged list queries), the exact-wave HNSW build, persistence across
the packages, and the API around them.

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties (two ids whose float64 distances agree within 1e-5).

Where the sums differ in order: tpu_knn's dot products are XLA einsums
over nnz, the port's one batched product or a sum per candidate, so
distances may differ by an ulp or two of f32 and tied ids may swap. The
pair dots of the construction heuristic add their products in a-side slot
order in both packages (tpu_knn's shipped fori_loop), and on the CPU the
port sums a gathered candidate's products and a row's squares one fused
multiply-add a slot, as XLA's CPU code does for these short reductions
(ops/sparse.row_dot), so the exact-wave graphs hold tpu_knn's neighbour
sets in every row on these inputs."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn.core.registry import create_space as j_create_space  # noqa: E402
from tpu_knn.methods import hnsw as JH  # noqa: E402
from tpu_knn.ops import graph as JG  # noqa: E402
from tpu_knn.ops import sparse as JS  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind as TDataKind, DataStore as TDataStore  # noqa: E402
from tpu_knn_torch.core.errors import InvalidArgumentError, InvalidSparseElementError  # noqa: E402
from tpu_knn_torch.core.registry import create_space as t_create_space  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.ops import graph as TG  # noqa: E402
from tpu_knn_torch.ops import sparse as TS  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}

#: every sparse name tpu_knn registers, with the parameters the tests give it
SPARSE = {
    "cosinesimil_sparse": {}, "cosinesimil_sparse_fast": {}, "cosinesimil_sparse_bin_fast": {},
    "angulardist_sparse": {}, "angulardist_sparse_fast": {},
    "negdotprod_sparse": {}, "negdotprod_sparse_fast": {}, "negdotprod_sparse_bin_fast": {},
    "querynorm_negdotprod_sparse": {}, "querynorm_negdotprod_sparse_fast": {},
    "l1_sparse": {}, "l2_sparse": {}, "linf_sparse": {}, "lp_sparse": {"p": 2.5},
    "sparse_jaccard": {}, "jaccard_sparse": {},
}
NAMES = sorted(SPARSE)
#: small exact-wave builds for the CPU
HNSW_BUILD = dict(M=8, efConstruction=40, waveSize=128, seed=0, sketchDim=0)


def corpus(n: int, seed: int):
    """Bag-of-words rows: sparse_like at the tests' size (vocab 2,000,
    16 terms a row, 12 topics)."""
    return sparse_like(n, vocab=2_000, nnz=16, n_clusters=12, seed=seed)


def rand_sparse(rng, n: int, universe: int = 300, max_nnz: int = 24):
    """Ragged rows with signed normal values (one empty row), ids 1-based
    and increasing."""
    pts = []
    for r in range(n):
        nnz = 0 if r == 1 else int(rng.integers(1, max_nnz))
        ids = np.sort(rng.choice(np.arange(1, universe + 1), size=nnz, replace=False))
        pts.append((ids.astype(np.int32), rng.standard_normal(nnz).astype(np.float32)))
    return pts


def oracle(name: str, q, x) -> float:
    """The reference formula of ``name`` in float64 (space_sparse_*.h)."""
    dq = {int(i): float(v) for i, v in zip(*q)}
    dx = {int(i): float(v) for i, v in zip(*x)}
    if name.endswith("_bin_fast") or "jaccard" in name:
        dq, dx = {i: 1.0 for i in dq}, {i: 1.0 for i in dx}
    keys = set(dq) | set(dx)
    if "jaccard" in name:
        inter = len(set(dq) & set(dx))
        return 1.0 - inter / len(keys) if keys else 0.0
    dot = sum(dq.get(i, 0.0) * dx.get(i, 0.0) for i in keys)
    nq, nx = math.sqrt(sum(v * v for v in dq.values())), math.sqrt(sum(v * v for v in dx.values()))
    if name.startswith("cosinesimil"):
        return max(0.0, 1.0 - dot / max(nq * nx, 1e-10))
    if name.startswith("angulardist"):
        return math.acos(max(-1.0, min(1.0, dot / max(nq * nx, 1e-10))))
    if name.startswith("querynorm"):
        return -dot / max(nq, 1e-10)
    if name.startswith("negdotprod"):
        return -dot
    if name == "linf_sparse":
        return max((abs(dq.get(i, 0.0) - dx.get(i, 0.0)) for i in keys), default=0.0)
    p = {"l1_sparse": 1.0, "l2_sparse": 2.0, "lp_sparse": 2.5}[name]
    s = sum(abs(dq.get(i, 0.0) - dx.get(i, 0.0)) ** p for i in keys)
    return s ** (1.0 / p)


def assert_close(name, got, ref):
    """Distances within the tolerance. An angular distance is compared as
    its cosine (within 1e-6): arccos is ill-conditioned at 0, where one
    ulp of an f32 cosine summed in another order moves it by ~5e-4."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if name.startswith("angulardist"):
        np.testing.assert_allclose(np.cos(got), np.cos(ref), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def assert_same_knn(name, xs, qs, ref, got):
    """Distances within the tolerance, ids equal except on float64 ties."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    assert_close(name, d2[fin], d1[fin])
    for r, c in zip(*np.nonzero(i1 != i2)):
        da, db = oracle(name, qs[r], xs[i1[r, c] - 1]), oracle(name, qs[r], xs[i2[r, c] - 1])
        assert abs(da - db) <= 1e-5 * max(abs(da), abs(db)) + 1e-6, (r, c, i1[r, c], i2[r, c], da, db)


def assert_same_range(ref, got, radius):
    """Equal hit sets except within the tolerance of the radius."""
    for rj, rt in zip(ref, got):
        assert rt.ids.dtype == np.int32 and np.all(np.diff(rt.dists) >= 0)
        mj, mt = dict(zip(rj.ids, rj.dists)), dict(zip(rt.ids, rt.dists))
        for i in set(mj) ^ set(mt):
            assert abs(mj.get(i, mt.get(i)) - radius) <= RTOL * abs(radius) + ATOL
        for i in set(mj) & set(mt):
            np.testing.assert_allclose(mt[i], mj[i], rtol=RTOL, atol=ATOL)


def assert_same_graph(t, j, n):
    """Every level's rows hold tpu_knn's neighbour sets (the order within a
    row may differ where two candidates' f32 distances tie)."""
    pairs = [(t.method.graph["level0"].numpy()[:n], np.asarray(j.method.graph["level0"])[:n])]
    assert len(t.method._upper) == len(j.method._upper)
    pairs += [(a.numpy(), np.asarray(b)[:a.shape[0]]) for a, b in zip(t.method._upper, j.method._upper)]
    for got, ref in pairs:
        assert got.shape == ref.shape
        bad = [r for r in range(len(ref)) if set(got[r]) != set(ref[r])]
        assert not bad, (bad[:5], got[bad[:2]], ref[bad[:2]])


def index(pkg, name, xs, method="seq_search", build=None):
    idx = pkg.Index(name, pkg.Params(SPARSE.get(name, {})), method=method, data_type="sparse_vector",
                    **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_sparse_batch(xs)
    if build is not None:
        idx.build_index(pkg.Params(build))
    return idx


def encode_both(name, xs):
    js = j_create_space(name, tpu_knn.Params(SPARSE[name]))
    ts = t_create_space(name, tpu_knn_torch.Params(SPARSE[name]), device="cpu")
    jstore, tstore = DataStore(DataKind.SPARSE), TDataStore(TDataKind.SPARSE)
    jstore.add_sparse_batch(xs)
    tstore.add_sparse_batch(xs)
    return js, ts, js.encode_dataset(jstore), ts.encode_dataset(tstore)


def np_of(d: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in d.items()}


# ---------------- encode and the space's scorers ----------------


@pytest.mark.parametrize("name", NAMES)
def test_block_matches_tpu_knn(name):
    """Encoded corpus and queries bit-equal to tpu_knn's (padded CSR, the
    padding sentinels, the vocabulary gate's width, q_pterm); the block
    within the tolerance of tpu_knn's and of the float64 oracle, on signed
    ragged rows (with an empty row) and on bag-of-words rows."""
    rng = np.random.default_rng(3)
    for xs, qs in ((rand_sparse(rng, 19), rand_sparse(rng, 6)), (corpus(40, 1), corpus(7, 2))):
        js, ts, jd, td = encode_both(name, xs)
        for a, b in ((td.col, jd.col), (td.val, jd.val), (td.length, jd.length), (td.ids, jd.ids),
                     (td.extra["pad"], jd.extra["pad"])):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert sorted(td.extra) == sorted(jd.extra)
        if "vocab_mark" in jd.extra:
            assert td.extra["vocab_mark"].shape == jd.extra["vocab_mark"].shape
        jq, tq = np_of(js.encode_queries(qs)), np_of(ts.encode_queries(qs))
        assert sorted(jq) == sorted(tq)
        for key in ("qcol", "qval", "qlen"):
            np.testing.assert_array_equal(tq[key], jq[key])
        if "q_pterm" in jq:
            np.testing.assert_allclose(tq["q_pterm"], jq["q_pterm"], rtol=1e-6)
        got = ts.block(ts.encode_queries(qs), ts.slice_data(td, 0, td.ids.shape[0])).numpy()
        ref = np.asarray(js.block(js.encode_queries(qs), js.slice_data(jd, 0, jd.ids.shape[0])))
        assert got.shape == ref.shape
        assert_close(name, got, ref)
        want = np.asarray([[oracle(name, q, x) for x in xs] for q in qs])
        assert_close(name, got[:, :len(xs)], want)
        assert np.all(got[:, len(xs):] >= 1e29)  # padding rows masked


@pytest.mark.parametrize("name", NAMES)
def test_gathered_and_pair_scoring_match_tpu_knn(name):
    """ops/graph.score_rows (each query against its own candidate rows,
    padding and -1 ids included) and the construction heuristic's pair
    distances (methods/hnsw._score_pairs over the corpus points as
    queries) equal tpu_knn's within the tolerance."""
    xs = corpus(60, 4)
    js, ts, jd, td = encode_both(name, xs)
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, td.ids.shape[0], size=(9, 11)).astype(np.int32)
    qs = corpus(9, 6)
    ref = np.asarray(JG.score_rows(js, js.encode_queries(qs), js.corpus_dict(jd), ids))
    got = TG.score_rows(ts, ts.encode_queries(qs), ts.corpus_dict(td), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert_close(name, got[fin], ref[fin])

    n = len(xs)
    jq_all = js.encode_queries(js.store_as_query_points(_store(DataStore, DataKind, xs)))
    tq_all = ts.encode_queries(ts.store_as_query_points(_store(TDataStore, TDataKind, xs)))
    a = rng.integers(-1, n, size=(5, 7)).astype(np.int32)
    b = rng.integers(-1, n, size=(5, 8)).astype(np.int32)
    ref = np.asarray(JH._score_pairs(js, jq_all, n, js.corpus_dict(jd), a, b))
    got = TH._score_pairs(ts, tq_all, n, ts.corpus_dict(td), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert_close(name, got[fin], ref[fin])


def _store(cls, kind, xs):
    st = cls(kind.SPARSE)
    st.add_sparse_batch(xs)
    return st


# ---------------- the primitives of ops/sparse.py ----------------


def _csr(pts, pad_col):
    from tpu_knn_torch.spaces.sparse import _pack_csr
    from tpu_knn_torch.core.dataset import SparsePoint

    col, val, length = _pack_csr([SparsePoint(i, v) for i, v in pts], len(pts), pad_col=pad_col)
    return col, val, length


def test_primitives_match_tpu_knn():
    """dot_qdense and intersect_count_qdense (the scan) against tpu_knn's
    [Q, V]-table versions; gathered_dot/gathered_found (the beam) against
    tpu_knn's shipped support_dots/support_found; pair_dots (the heuristic)
    bit-equal to tpu_knn's shipped _pair_dots_support; the union Lp and
    Linf against tpu_knn's searchsorted forms; norms and jaccard."""
    rng = np.random.default_rng(11)
    qs, xs = rand_sparse(rng, 5), rand_sparse(rng, 12)
    qcol, qval, qlen = _csr(qs, TS.PAD_Q)
    xcol, xval, xlen = _csr(xs, TS.PAD_X)
    def t(a):
        return torch.from_numpy(np.array(a))

    v_pad = 384
    qd = np.asarray(JS._densify(qcol, qval, v_pad))
    np.testing.assert_array_equal(TS.densify(t(qcol), t(qval), v_pad).numpy(), qd)
    qd_t = TS.densify_t(t(qcol), t(qval), v_pad)
    np.testing.assert_allclose(TS.dot_qdense(qd_t, t(xcol), t(xval)).numpy(),
                               np.asarray(JS.dot_qdense(qd, xcol, xval)), rtol=1e-6, atol=1e-6)
    pres = np.asarray(JS._densify(qcol, np.ones_like(qval), v_pad))
    np.testing.assert_array_equal(
        TS.intersect_count_qdense(TS.densify_t(t(qcol), t(np.ones_like(qval)), v_pad), t(xcol)).numpy(),
        np.asarray(JS.intersect_count_qdense(pres, xcol)))

    # each query's own candidates [B, K, nnz]
    pick = rng.integers(0, len(xs), size=(5, 4))
    cols, vals = xcol[pick], xval[pick]
    np.testing.assert_allclose(TS.gathered_dot(t(qd), t(cols), t(vals)).numpy(),
                               np.asarray(JS.support_dots(qcol, qval, cols, vals)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TS.gathered_found(t(pres), t(cols)).numpy(),
                                  np.asarray(JS.support_found(qcol, cols)).sum(-1))

    # pairs of candidate rows [B, C, nnz] x [B, C2, nnz]
    pa, pb = rng.integers(0, len(xs), size=(3, 4)), rng.integers(0, len(xs), size=(3, 5))
    np.testing.assert_array_equal(
        TS.pair_dots(t(xcol[pa]), t(xval[pa]), t(xcol[pb]), t(xval[pb])).numpy(),
        np.asarray(JS._pair_dots_support(xcol[pa], xval[pa], xcol[pb], xval[pb])))
    ones = (xcol >= 1) & (xcol < TS.PAD_X)
    np.testing.assert_array_equal(
        TS.pair_intersect(t(xcol[pa]), t(xcol[pb])).numpy(),
        np.asarray(JS._pair_dots_support(xcol[pa], ones[pa].astype(np.float32), xcol[pb],
                                         ones[pb].astype(np.float32))))

    for p in (1.0, 2.0, 2.5):
        pterm = np.sum(np.abs(qval) ** p, axis=1).astype(np.float32)
        np.testing.assert_allclose(
            TS.lp_union_blocked(t(qcol), t(qval), t(xcol), t(xval), p, t(pterm)).numpy(),
            np.asarray(JS.lp_union_blocked(qcol, qval, xcol, xval, p, pterm)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TS.linf_union_blocked(t(qcol), t(qval), t(xcol), t(xval)).numpy(),
                                  np.asarray(JS.linf_union_blocked(qcol, qval, xcol, xval)))
    np.testing.assert_allclose(TS.norms_from_vals(t(xval)).numpy(), np.asarray(JS.norms_from_vals(xval)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        TS.jaccard_from_counts(TS.intersect_count_qdense(TS.densify_t(t(qcol), t(np.ones_like(qval)), v_pad),
                                                         t(xcol)), t(qlen)[:, None].float(),
                               t(xlen)[None, :].float()).numpy(),
        np.asarray(JS.jaccard_blocked(qcol, xcol, qlen, xlen)), rtol=1e-6)


# ---------------- the exact scan ----------------


@pytest.mark.parametrize("name", NAMES)
def test_knn_range_async_match_tpu_knn(name):
    """knn_query_batch with a ragged list of 21 queries (padded to a
    bucket of 32 by repeating the first), its async form, and
    range_query_batch at the median 10th-neighbour distance, against
    tpu_knn's seq_search on the same 1,024 rows."""
    xs, qs = corpus(1024, 7), corpus(21, 8)
    j, t = index(tpu_knn, name, xs), index(tpu_knn_torch, name, xs)
    ref = j.knn_query_batch(qs, 10)
    got = t.knn_query_batch(qs, 10)
    assert t.method.last_route == "single"
    assert_same_knn(name, xs, qs, ref, got)
    d_a, i_a = t.knn_query_batch_async(qs, 10).result()
    np.testing.assert_array_equal(i_a, got[1])
    np.testing.assert_array_equal(d_a, got[0])
    radius = float(np.median(ref[0][:, -1]))
    assert_same_range(j.range_query_batch(qs, radius), t.range_query_batch(qs, radius), radius)
    one = t.knn_query(qs[3], 10)
    np.testing.assert_array_equal(one.ids, got[1][3])


def test_sparse_scan_stays_single_pass():
    """twopass_ok=False keeps a sparse corpus on the single pass where a
    dense one of the same row count takes the two-pass route (3,072 rows
    >= 8 (k+2) 128 at k=1), as tpu_knn's _plan_knn does."""
    xs, qs = corpus(3072, 9), corpus(8, 10)
    t, j = index(tpu_knn_torch, "negdotprod_sparse", xs), index(tpu_knn, "negdotprod_sparse", xs)
    got = t.knn_query_batch(qs, 1)
    assert t.method.last_route == "single"
    assert_same_knn("negdotprod_sparse", xs, qs, j.knn_query_batch(qs, 1), got)
    dense = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=8), method="seq_search", **CPU)
    dense.add_dense_batch(np.random.default_rng(0).standard_normal((3072, 8)).astype(np.float32))
    dense.knn_query_batch(np.zeros((2, 8), np.float32), 1)
    assert dense.method.last_route == "twopass"


def test_unbounded_vocabulary_uses_the_lookup():
    """Element ids past VOCAB_DENSE_MAX leave the corpus without the
    vocabulary gate: the dot family then scores by binary search, as
    tpu_knn does, with the same results."""
    rng = np.random.default_rng(12)
    xs = [(np.sort(rng.choice(np.arange(1, 200_000), 9, replace=False)).astype(np.int32),
           rng.random(9).astype(np.float32)) for _ in range(64)]
    qs = [(np.concatenate([x[0][:4], [199_999]]).astype(np.int32), rng.random(5).astype(np.float32))
          for x in xs[:6]]
    for name in ("cosinesimil_sparse", "sparse_jaccard"):
        t, j = index(tpu_knn_torch, name, xs), index(tpu_knn, name, xs)
        assert_same_knn(name, xs, qs, j.knn_query_batch(qs, 5), t.knn_query_batch(qs, 5))
        assert "vocab_mark" not in t.method.data.extra


# ---------------- HNSW with exact waves ----------------


@pytest.mark.parametrize("name,n", [("cosinesimil_sparse", 1024), ("l2_sparse", 512), ("sparse_jaccard", 512)])
def test_hnsw_exact_waves_equal_tpu_knn(tmp_path, name, n):
    """sketchDim=0 builds with exact waves (the gathered scorer in the
    beams, the pair scorer in the heuristic): every row of level 0 and of
    the upper levels holds tpu_knn's neighbour set, search results equal, and a
    graph either package saved loads and searches in the other."""
    xs, qs = corpus(n, 13), corpus(24, 14)
    j = index(tpu_knn, name, xs, "hnsw", HNSW_BUILD)
    t = index(tpu_knn_torch, name, xs, "hnsw", HNSW_BUILD)
    assert t.method._proxy is None
    assert t.method.check_graph() == {"self_links": 0, "dup_links": 0, "oob_links": 0}
    assert_same_graph(t, j, n)
    for idx, pkg in ((j, tpu_knn), (t, tpu_knn_torch)):
        idx.set_query_time_params(pkg.Params(efSearch=40))
    ref = j.knn_query_batch(qs, 10)
    assert_same_knn(name, xs, qs, ref, t.knn_query_batch(qs, 10))
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / f"{reader.__name__}_reads")
        src.save(path)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        back.set_query_time_params(reader.Params(efSearch=40))
        assert_same_knn(name, xs, qs, ref, back.knn_query_batch(qs, 10))


# ---------------- persistence and the API ----------------


@pytest.mark.parametrize("save_data", [True, False])
def test_scan_files_cross_both_ways(tmp_path, save_data):
    """A sparse seq_search index saved by either package (data embedded or
    in its .dat.npz) loads in the other, in both load modes, with the
    same store and the same answers."""
    xs, qs = corpus(300, 15), corpus(9, 16)
    j, t = index(tpu_knn, "l1_sparse", xs), index(tpu_knn_torch, "l1_sparse", xs)
    ref = j.knn_query_batch(qs, 5)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / f"{reader.__name__}_{save_data}")
        src.save(path, save_data=save_data)
        for load_data in (True, False):
            back = reader.Index.load(path, load_data=load_data, **(CPU if reader is tpu_knn_torch else {}))
            assert back.get_space_type() == "l1_sparse"
            p = back.borrow_data_sparse(7)
            np.testing.assert_array_equal(p.ids, xs[7][0])
            np.testing.assert_array_equal(p.values, xs[7][1])
            assert_same_knn("l1_sparse", xs, qs, ref, back.knn_query_batch(qs, 5))


def test_add_borrow_ids_and_validation():
    """add_sparse_batch with default 1-based ids and with given ids,
    borrow_data_sparse, SparsePoint queries, and tpu_knn's errors for ids
    that are not >= 1 and strictly increasing."""
    from tpu_knn_torch import SparsePoint

    xs = corpus(20, 17)
    t = index(tpu_knn_torch, "cosinesimil_sparse", xs)
    _, ids = t.knn_query_batch([SparsePoint(*xs[4])], 1)
    assert ids[0, 0] == 5
    g = tpu_knn_torch.Index("negdotprod_sparse", method="seq_search", data_type="sparse_vector", **CPU)
    g.add_sparse_batch(xs[:10], ids=range(100, 110))
    g.add_sparse_batch(xs[10:12])
    p = g.borrow_data_sparse(3)
    assert isinstance(p, SparsePoint)
    np.testing.assert_array_equal(p.ids, xs[3][0])
    np.testing.assert_array_equal(p.values, xs[3][1])
    j = tpu_knn.Index("negdotprod_sparse", method="seq_search", data_type="sparse_vector")
    j.add_sparse_batch(xs[:10], ids=range(100, 110))
    j.add_sparse_batch(xs[10:12])
    np.testing.assert_array_equal(g.knn_query_batch(xs[:3], 4)[1], j.knn_query_batch(xs[:3], 4)[1])
    for bad in ([0, 2], [3, 2], [2, 2]):
        pt = [(np.asarray(bad), np.asarray([1.0, 2.0], np.float32))]
        with pytest.raises(InvalidSparseElementError):
            g.add_sparse_batch(pt)
        with pytest.raises(tpu_knn.InvalidSparseElementError):
            j.add_sparse_batch(pt)


@pytest.mark.parametrize("p", [0.0, -1.5])
def test_lp_sparse_parameter_errors_equal_tpu_knn(p):
    with pytest.raises(tpu_knn.InvalidArgumentError) as je:
        tpu_knn.Index("lp_sparse", tpu_knn.Params(p=p), data_type="sparse_vector")
    with pytest.raises(InvalidArgumentError) as te:
        tpu_knn_torch.Index("lp_sparse", tpu_knn_torch.Params(p=p), data_type="sparse_vector", **CPU)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n,vocab,nnz,seed", [(700, 2_000, 16, 0), (300, 30_000, 64, 5)])
def test_sparse_like_equals_tpu_knn(tmp_path, monkeypatch, n, vocab, nnz, seed):
    """One seed gives one corpus in both packages (each drawing afresh)."""
    import tpu_knn.eval.datasets as JD
    import tpu_knn_torch.eval.datasets as TD

    monkeypatch.setattr(JD, "_CACHE_DIR", str(tmp_path / "j"))
    monkeypatch.setattr(TD, "_CACHE_DIR", str(tmp_path / "t"))
    a, b = JD.sparse_like(n, vocab=vocab, nnz=nnz, seed=seed), TD.sparse_like(n, vocab=vocab, nnz=nnz, seed=seed)
    assert len(a) == len(b) == n
    for (ia, va), (ib, vb) in zip(a, b):
        assert ia.dtype == ib.dtype == np.int32 and va.dtype == vb.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)
