"""simple_invindx and the term-at-a-time engine (ops/inverted.py) in the
port (device="cpu"), held against tpu_knn on the same seeded numpy inputs
(sparse_like rows, vocab 2,000, 16 terms a row; negdotprod_sparse_fast).

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties. The port sums each (document, query) cell in the order of
tpu_knn's scatter-add on the CPU (union terms ascending, then blocks, then
slots) without atomics, so its scores are tpu_knn's bits here; and a
query's bits do not depend on the batch around it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.ops import inverted as JIV  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402
from tpu_knn_torch.ops import inverted as TIV  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
PKGS = (tpu_knn, tpu_knn_torch)
SPACE = "negdotprod_sparse_fast"


def _corpus(n: int = 1500, seed: int = 9):
    return sparse_like(n, vocab=2_000, nnz=16, n_clusters=12, seed=seed)


def _index(pkg, pts, method="simple_invindx", space=SPACE):
    idx = pkg.Index(space, method=method, data_type="sparse_vector", **(CPU if pkg is tpu_knn_torch else {}))
    idx.add_sparse_batch(pts)
    return idx


def _assert_same_knn(ref, got):
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, -1], rtol=RTOL, atol=ATOL), (r, c)


@pytest.mark.parametrize("nq", [1, 7, 64])
def test_taat_matches_tpu_knn(nq):
    """kNN at k=10: ids equal except on ties, distances within the
    tolerance (equal bits, in fact), touched documents (dist_comps) equal."""
    pts = _corpus()
    q = sparse_like(nq, vocab=2_000, nnz=16, n_clusters=12, seed=100 + nq)
    j, t = _index(tpu_knn, pts), _index(tpu_knn_torch, pts)
    ref, got = j.knn_query_batch(q, 10), t.knn_query_batch(q, 10)
    _assert_same_knn(ref, got)
    np.testing.assert_array_equal(got[0], ref[0])
    assert t.method.dist_comps == j.method.dist_comps > 0


def test_postings_and_plan_equal_tpu_knn():
    """build_postings and plan_batch are tpu_knn's host numpy: the same
    arrays from the same padded CSR."""
    pts = _corpus(700, 10)
    t = _index(tpu_knn_torch, pts)
    t.build_index()
    m = t.method
    col, val = m.data.col.numpy(), m.data.val.numpy()
    ji = JIV.build_postings(col, val, m.data.count, int(m.data.ids.shape[0]))
    ti = m._inv
    np.testing.assert_array_equal(ti.pdoc_blocks.numpy(), np.asarray(ji.pdoc_blocks))
    np.testing.assert_array_equal(ti.pval_blocks.numpy(), np.asarray(ji.pval_blocks))
    for a in ("blk_start", "blk_count"):
        np.testing.assert_array_equal(getattr(ti, a), getattr(ji, a))
    assert (ti.vocab, ti.n_rows, ti.total_postings) == (ji.vocab, ji.n_rows, ji.total_postings)
    qcol, qval = m._host_queries(sparse_like(9, vocab=2_000, nnz=16, n_clusters=12, seed=11))
    for a, b in zip(TIV.plan_batch(qcol, qval, ti), JIV.plan_batch(qcol, qval, ji)):
        np.testing.assert_array_equal(a, b)


def test_ordered_accumulation_equals_a_sequential_scatter():
    """_add_slice adds every real posting into its document's row in
    posting order: the same bits as a one-by-one f32 loop, with repeated
    documents, padding slots and cancelling values."""
    rng = np.random.default_rng(12)
    n_rows, nq, p = 40, 5, 900
    doc = rng.integers(-1, n_rows, size=p).astype(np.int32)
    val = rng.standard_normal(p).astype(np.float32)
    ub = rng.integers(0, 7, size=p)
    w = rng.standard_normal((7, nq)).astype(np.float32)
    w[3] = 0.0
    want = np.zeros((n_rows, nq), np.float32)
    for i in range(p):
        if doc[i] >= 0:
            want[doc[i]] = want[doc[i]] + val[i] * w[ub[i]]
    got = torch.full((n_rows, nq), 0.0)
    TIV._add_slice(got, torch.from_numpy(doc), torch.from_numpy(val), torch.from_numpy(ub), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_deterministic_and_independent_of_the_batch():
    """Two calls give equal bits, and a permuted batch gives each query
    the bits it had."""
    pts = _corpus()
    q = sparse_like(24, vocab=2_000, nnz=16, n_clusters=12, seed=13)
    t = _index(tpu_knn_torch, pts)
    d, i = t.knn_query_batch(q, 10)
    d2, i2 = t.knn_query_batch(q, 10)
    np.testing.assert_array_equal(d, d2)
    np.testing.assert_array_equal(i, i2)
    perm = np.random.default_rng(14).permutation(24)
    dp, ip = t.knn_query_batch([q[p] for p in perm], 10)
    np.testing.assert_array_equal(dp, d[perm])
    np.testing.assert_array_equal(ip, i[perm])
    d1, i1 = t.knn_query_batch(q[5:6], 10)
    np.testing.assert_array_equal(d1[0], d[5])
    np.testing.assert_array_equal(i1[0], i[5])


def test_topk_pass_does_not_depend_on_its_chunk():
    """The accumulator's top-k over any slice width, a ragged last slice
    included, gives the same bits (tpu_knn takes the widest divisor of the
    row count; the port streams 8192-row slices)."""
    t = _index(tpu_knn_torch, _corpus(2300, 18))
    t.build_index()
    m = t.method
    qcol, qval = m._host_queries(sparse_like(12, vocab=2_000, nnz=16, n_clusters=12, seed=19))
    plan = TIV.plan_batch(qcol, qval, m._inv)
    outs = [TIV.taat_topk(m._inv.pdoc_blocks, m._inv.pval_blocks, *plan, m.data.ids, 10, c)
            for c in (256, 1000, 8192)]
    assert m._inv.n_rows == 2304
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


def test_taat_against_the_exact_scan():
    """Every returned id is a touched document (a finite distance), with
    the exact scan's distance; ids equal the scan's except on ties where
    the query touches at least k documents."""
    pts = _corpus()
    q = sparse_like(16, vocab=2_000, nnz=16, n_clusters=12, seed=15)
    t = _index(tpu_knn_torch, pts)
    ex = _index(tpu_knn_torch, pts, method="seq_search")
    d, i = t.knn_query_batch(q, 10)
    ed, ei = ex.knn_query_batch(q, 10)
    both = (i >= 0) & (ei >= 0)
    assert both.all() and np.isfinite(d).all() and (d < 0).all()
    _assert_same_knn((ed, ei), (d, i))


def test_method_contract_equals_tpu_knn(tmp_path):
    """The space gate (SpaceIncompatibleError for any space but
    negdotprod_sparse(_fast)), no range, dummyParam accepted and unknown
    parameters refused, k beyond the touched documents and an empty index
    padded with (+inf, -1), async results, and files across the packages."""
    pts = _corpus(300, 16)
    q = sparse_like(6, vocab=2_000, nnz=16, n_clusters=12, seed=17)
    for pkg in PKGS:
        for space in ("cosinesimil_sparse", "negdotprod_sparse_bin_fast", "l2_sparse"):
            with pytest.raises(pkg.SpaceIncompatibleError):
                _index(pkg, pts, space=space).build_index()
        idx = _index(pkg, pts, space="negdotprod_sparse")
        idx.build_index({"dummyParam": 3})
        with pytest.raises(pkg.SpaceIncompatibleError):
            idx.range_query_batch(q, -1.0)
        with pytest.raises(pkg.InvalidArgumentError):
            idx.set_query_time_params({"efSearch": 3})
        idx.set_query_time_params({"dummyParam": 1})
        d, i = idx.knn_query_batch([([1999], [1.0])], 5)
        assert (i == -1).all() and np.isinf(d).all()
        empty = pkg.Index(SPACE, method="simple_invindx", data_type="sparse_vector",
                          **(CPU if pkg is tpu_knn_torch else {}))
        d, i = empty.knn_query_batch(q, 3)
        assert (i == -1).all() and np.isinf(d).all()
    j, t = _index(tpu_knn, pts), _index(tpu_knn_torch, pts)
    ref = t.knn_query_batch(q, 400)
    _assert_same_knn(j.knn_query_batch(q, 400), ref)
    assert (ref[1] == -1).any()  # fewer touched documents than k
    f = t.knn_query_batch_async(q, 400)
    for a, b in zip(f.result(), ref):
        np.testing.assert_array_equal(a, b)
    for src, reader in ((j, tpu_knn_torch), (t, tpu_knn)):
        path = str(tmp_path / reader.__name__)
        src.save(path)
        back = reader.Index.load(path, **(CPU if reader is tpu_knn_torch else {}))
        _assert_same_knn(ref, back.knn_query_batch(q, 400))
