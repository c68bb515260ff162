"""The sparse exact scan of the dot spaces and Jaccard (ops/sparse.py
``qdense_dists``, csrc/sparse_qdense.cu on the card) on the CPU, held
against tpu_knn on the same seeded numpy inputs: its plain version (on the
table that the batch's postings hold) and an f32 model of the densified
table's slot-order arithmetic against tpu_knn's ``space.block`` on its
densified-table route, the wrapper's contract, and the port's
``seq_search`` kNN and range against tpu_knn's.

The inputs are ``sparse_like`` rows with edge rows appended: empty rows,
zero-norm rows (real ids with value 0), a row of one element, a query with
no elements and one whose ids lie beyond the corpus vocabulary; the query
and row counts are multiples of no tile of the kernel (128 queries x 32
rows a block). Tolerances are ROADMAP.md's, rtol 5e-3 and atol 1e-5 (an
angular distance as its cosine within 1e-6: arccos is ill-conditioned near
0); the 0/1 forms and Jaccard sum integers, which every order sums exactly,
so there they are equal."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn.core.registry import create_space as j_create_space  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind as TDataKind, DataStore as TDataStore  # noqa: E402
from tpu_knn_torch.core.registry import create_space as t_create_space  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402
from tpu_knn_torch.ops import sparse as S  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
VOCAB = 2_000
#: space name -> (qdense form, whether its sums are integers)
NAMES = {
    "cosinesimil_sparse": ("cosine", False), "angulardist_sparse": ("angular", False),
    "negdotprod_sparse": ("negdot", False), "querynorm_negdotprod_sparse": ("querynorm", False),
    "cosinesimil_sparse_bin_fast": ("cosine", True), "negdotprod_sparse_bin_fast": ("negdot", True),
    "sparse_jaccard": ("jaccard", True),
}


def _edge_rows():
    """Empty, zero-norm, one-element and long rows."""
    ids = np.arange(1, 200, 3, dtype=np.int32)
    return [(np.zeros(0, np.int32), np.zeros(0, np.float32)),
            (np.array([5, 17, 400], np.int32), np.zeros(3, np.float32)),
            (np.array([7], np.int32), np.array([2.5], np.float32)),
            (ids, np.linspace(0.5, 2.0, ids.size).astype(np.float32)),
            (np.zeros(0, np.int32), np.zeros(0, np.float32))]


def corpus_queries(n: int = 296, nq: int = 21):
    """``n`` + 5 corpus rows and ``nq`` + 3 queries (an empty one, one
    beyond the vocabulary, one with ids on both sides of it)."""
    xs = sparse_like(n, vocab=VOCAB, nnz=16, n_clusters=12, seed=31) + _edge_rows()
    qs = sparse_like(nq, vocab=VOCAB, nnz=16, n_clusters=12, seed=32)
    qs += [(np.zeros(0, np.int32), np.zeros(0, np.float32)),
           (np.array([VOCAB + 300, VOCAB + 900], np.int32), np.ones(2, np.float32)),
           (np.array([5, 7, 17, VOCAB + 50], np.int32), np.array([1.0, -2.0, 0.5, 3.0], np.float32))]
    return xs, qs


def encode_both(name, xs, qs):
    js = j_create_space(name, tpu_knn.Params())
    ts = t_create_space(name, tpu_knn_torch.Params(), device="cpu")
    jst, tst = DataStore(DataKind.SPARSE), TDataStore(TDataKind.SPARSE)
    jst.add_sparse_batch(xs)
    tst.add_sparse_batch(xs)
    jd, td = js.encode_dataset(jst), ts.encode_dataset(tst)
    n_pad = td.ids.shape[0]
    ref = np.asarray(js.block(js.encode_queries(qs), js.slice_data(jd, 0, n_pad)))
    xc = ts.slice_data(td, 0, n_pad)
    qenc = ts.densify_queries(ts.encode_queries(qs), xc, scan=True)
    assert "q_post" in qenc  # the postings route
    return ts, qenc, xc, ref


def qdense_args(name, qenc, xc):
    form = NAMES[name][0]
    qn = S.norms_from_vals(qenc["qval"])
    return (form, qenc["q_post"], xc["cols"], None if form == "jaccard" else xc["x"], qn, qenc["qlen"],
            xc["len"], xc["pad"])


def table_args(args):
    """``args`` of :func:`qdense_args` with the postings' densified table in their place: the
    inputs of :func:`kernel_model`."""
    return (args[0], S.postings_table(args[1])) + tuple(args[2:])


def kernel_model(form, table, xcol, w, qn, qlen, xlen, pad):
    """The kernel's arithmetic in f32 on the CPU: each corpus element's
    table row (id clamped into the table), the slots of a row past its last
    real one skipped (their weight is 0), one fused multiply-add a slot in
    slot order for the sums and the row's squares, then the post and pad."""
    v = table.shape[0]
    real = (xcol >= 1) & (xcol < S.PAD_X)
    slots = torch.arange(xcol.shape[1])
    last = torch.where(real, slots, -1).amax(dim=1)  # packed rows have at least 8 slots
    used = slots[None, :] <= last[:, None]
    w = real.float() if form == "jaccard" else w
    w = torch.where(used, w, 0.0)
    g = table[(xcol.long() - 1).clamp(0, v - 1)]  # [C, nnz, Q]
    dot = S._seq_sum(g.permute(2, 0, 1), w[None].expand(g.shape[2], -1, -1))  # [Q, C]
    if form == "jaccard":
        return S.jaccard_from_counts(dot, qlen[:, None], xlen[None, :]) + pad[None, :]
    xn = torch.sqrt(S._seq_sum(w, w))
    return S.dot_post(form, dot, qn[:, None], xn[None, :]) + pad[None, :]


def assert_matches(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    if NAMES[name][1]:
        np.testing.assert_array_equal(got, ref)
    elif name.startswith("angulardist"):
        np.testing.assert_allclose(np.cos(got.astype(np.float64)), np.cos(ref.astype(np.float64)), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(NAMES))
def test_reference_and_kernel_model_match_tpu_knn(name):
    """qdense_dists_reference (the plain version) and the f32 model of the
    kernel, each against tpu_knn's block on its densified-table route, and
    the space's own block (one qdense_dists call) equal to the plain
    version; padding rows masked."""
    xs, qs = corpus_queries()
    ts, qenc, xc, ref = encode_both(name, xs, qs)
    args = qdense_args(name, qenc, xc)
    plain = S.qdense_dists_reference(*args)
    assert plain.shape == (len(qs), xc["cols"].shape[0])
    assert_matches(name, plain.numpy(), ref)
    assert_matches(name, kernel_model(*table_args(args)).numpy(), ref)
    np.testing.assert_array_equal(ts.block(qenc, xc).numpy(), plain.numpy())
    assert np.all(plain.numpy()[:, len(xs):] >= 1e29)


@pytest.mark.parametrize("nnz", [1, 200])
def test_kernel_model_at_short_and_long_rows(nnz):
    """Rows of exactly 1 and up to 200 slots (several of the kernel's
    64-slot stages), padding inside the stage included: the model against
    the plain version in every form, and against a float64 evaluation."""
    rng = np.random.default_rng(nnz)
    from tpu_knn_torch.core.dataset import SparsePoint
    from tpu_knn_torch.spaces.sparse import _pack_csr

    def rows(n, k):
        out = []
        for r in range(n):
            m = k if r % 3 else int(rng.integers(0, k + 1))
            ids = np.sort(rng.choice(np.arange(1, 600), size=m, replace=False)).astype(np.int32)
            out.append(SparsePoint(ids, rng.standard_normal(m).astype(np.float32)))
        return out

    xp, qp = rows(37, nnz), rows(9, 40)
    xcol, xval, xlen = (torch.from_numpy(a) for a in _pack_csr(xp, 40))
    qcol, qval, qlen = (torch.from_numpy(a) for a in _pack_csr(qp, 9, pad_col=S.PAD_Q))
    pad = torch.zeros(40)
    pad[37:] = 1e30
    qn = S.norms_from_vals(qval)
    for form in S.QDENSE_FORMS:
        vals = torch.ones_like(qval) if form == "jaccard" else qval
        args = (form, S.postings(qcol, vals, 640), xcol, xval, qn, qlen, xlen, pad)
        got, ref = kernel_model(*table_args(args)).numpy(), S.qdense_dists_reference(*args).numpy()
        if form == "jaccard":
            np.testing.assert_array_equal(got, ref)
        elif form == "angular":
            np.testing.assert_allclose(np.cos(got.astype(np.float64)), np.cos(ref.astype(np.float64)), atol=1e-6)
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # negdot against float64 dots
    dq = np.zeros((9, 640))
    dx = np.zeros((37, 640))
    for r, p in enumerate(qp):
        dq[r, p.ids - 1] = p.values
    for r, p in enumerate(xp):
        dx[r, p.ids - 1] = p.values
    got = kernel_model("negdot", S.densify_t(qcol, qval, 640), xcol, xval, qn, qlen, xlen, pad).numpy()
    np.testing.assert_allclose(got[:, :37], -(dq @ dx.T), rtol=1e-5, atol=1e-5)


def test_qdense_dists_on_the_cpu_never_builds(monkeypatch):
    """On a CPU tensor the wrapper runs its plain version and never builds
    or loads the kernel; the launch itself raises on a CPU tensor before
    it would, and the contract's errors come first on any device."""
    def no_build(*a, **k):
        raise AssertionError("the kernel was built on the CPU")

    monkeypatch.setattr(GM, "build_all", no_build)
    monkeypatch.setattr(GM, "_load", no_build)
    before = dict(GM.launches)
    xs, qs = corpus_queries(40, 5)
    _, qenc, xc, _ = encode_both("cosinesimil_sparse", xs, qs)
    args = qdense_args("cosinesimil_sparse", qenc, xc)
    np.testing.assert_array_equal(S.qdense_dists(*args).numpy(), S.qdense_dists_reference(*args).numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        S._qdense_launch(*args)
    assert GM.launches == before
    form, post, xcol, w, qn, qlen, xlen, pad = args
    with pytest.raises(ValueError, match="unknown form"):
        S.qdense_dists("l2", post, xcol, w, qn, qlen, xlen, pad)
    with pytest.raises(ValueError, match="xcol"):
        S.qdense_dists(form, post, xcol.long(), w, qn, qlen, xlen, pad)
    with pytest.raises(ValueError, match="qn"):
        S.qdense_dists(form, post, xcol, w, None, qlen, xlen, pad)
    with pytest.raises(ValueError, match="xlen"):
        S.qdense_dists("jaccard", post, xcol, None, None, qlen, xlen.long(), pad)
    with pytest.raises(ValueError, match="pad"):
        S.qdense_dists(form, post, xcol, w, qn, qlen, xlen, pad[:-1])
    with pytest.raises(ValueError, match="Postings"):
        S.qdense_dists(form, S.postings_table(post), xcol, w, qn, qlen, xlen, pad)


def test_kernel_source_agrees_with_the_wrapper():
    """The source's form numbering is QDENSE_FORMS', its padding sentinel
    PAD_X, its query tile the postings', its launches counted under one key
    a form, and it is built with the other kernels."""
    src = GM.SOURCES["sparse_qdense"].read_text()
    enum = re.search(r"enum Form \{([^}]*)\}", src).group(1)
    assert [e.split("=")[0].strip().lower() for e in enum.split(",")] == list(S.QDENSE_FORMS)
    assert f"PAD_X = {S.PAD_X};" in src
    assert f"QT = {S.POST_TILE};" in src
    assert GM.SPARSE_QDENSE == tuple(f"sparse_qdense_{f}" for f in S.QDENSE_FORMS)
    assert set(GM.SPARSE_QDENSE) <= set(GM.launches)
    assert "fast_math" not in " ".join(GM.NVCC_FLAGS) and "use_fast_math" not in src


@pytest.mark.parametrize("name", ["cosinesimil_sparse", "sparse_jaccard"])
def test_seq_search_knn_and_range_match_tpu_knn(monkeypatch, name):
    """Index(..., method="seq_search", device="cpu") kNN and range, one
    qdense_dists call per scanned chunk in the space's form, against
    tpu_knn.Index on the same rows: distances within the tolerance, ids
    equal up to float64 ties."""
    from test_torch_sparse import assert_same_knn, assert_same_range

    xs, qs = corpus_queries(600, 13)
    calls = []
    real = S.qdense_dists
    monkeypatch.setattr(S, "qdense_dists", lambda form, *a: calls.append(form) or real(form, *a))
    j = tpu_knn.Index(name, method="seq_search", data_type="sparse_vector")
    t = tpu_knn_torch.Index(name, method="seq_search", data_type="sparse_vector", device="cpu")
    j.add_sparse_batch(xs)
    t.add_sparse_batch(xs)
    ref, got = j.knn_query_batch(qs, 10), t.knn_query_batch(qs, 10)
    chunks = t.method.data.ids.shape[0] // t.method._chunk
    assert calls == [NAMES[name][0]] * chunks
    assert_same_knn(name, xs, qs, ref, got)
    radius = float(np.median(ref[0][:, -1]))
    assert_same_range(j.range_query_batch(qs, radius), t.range_query_batch(qs, radius), radius)
