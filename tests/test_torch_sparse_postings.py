"""The sparse scan's query side and kernel arithmetic on the CPU: a query
batch's term-major postings (ops/sparse.postings, the input of
csrc/sparse_qdense.cu) and an f32 model of the kernel's postings walk, held
against the densified table of ``densify_t``, the earlier kernel's f32
model (test_torch_sparse_scan.kernel_model), the plain version and
tpu_knn's ``space.block``, on seeded numpy inputs.

The model walks what the kernel walks: for each corpus row, its real slots
in order; for each, the run of query records of the slot's id; one fused
multiply-add a record (``addcmul`` rounds once). A slot whose weight is
+-inf or NaN adds, as the kernel's dense-slice path does, the product with
every query's value (0 where the query lacks the id). Query counts are
multiples of no tile (128 queries) and of no row group (32 rows); nnz 16
and 24. Tolerances are ROADMAP.md's (rtol 5e-3, atol 1e-5) where the
plain version's batched product sums in another order; the model against
the earlier model is ``torch.equal``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from test_torch_sparse_scan import NAMES, encode_both, kernel_model, qdense_args, table_args  # noqa: E402
from tpu_knn.core.dataset import DataKind, DataStore  # noqa: E402
from tpu_knn.core.registry import create_space as j_create_space  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind as TDataKind, DataStore as TDataStore, SparsePoint  # noqa: E402
from tpu_knn_torch.core.registry import create_space as t_create_space  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402
from tpu_knn_torch.methods.seq_search import _slice_qenc  # noqa: E402
from tpu_knn_torch.ops import sparse as S  # noqa: E402
from tpu_knn_torch.spaces.sparse import _pack_csr  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
V = 700


def query_rows(nq: int, nnz: int, seed: int):
    """Queries of ``nnz`` ids drawn from 1..V + 60 (some past the vocabulary), with every kind of
    edge: empty queries, zero and negative values, and id 3 held by every non-empty query."""
    rng = np.random.default_rng(seed)
    pts = []
    for r in range(nq):
        m = 0 if r % 9 == 4 else int(rng.integers(1, nnz + 1))
        ids = np.sort(rng.choice(np.arange(1, V + 61), size=m, replace=False))
        if m and 3 not in ids:
            ids = np.sort(np.concatenate([[3], ids[1:]]))
        vals = rng.standard_normal(m).astype(np.float32)
        if r % 7 == 2 and m:
            vals[0] = 0.0
        pts.append(SparsePoint(ids.astype(np.int32), vals))
    col, val, length = (torch.from_numpy(a) for a in _pack_csr(pts, nq, pad_col=S.PAD_Q))
    return col, val, length


@pytest.mark.parametrize("nq,nnz", [(1, 16), (7, 24), (130, 16), (300, 24)])
def test_postings_densify_to_densify_t(nq, nnz):
    """The postings of a batch densify back to densify_t's table, value for value (zero and
    negative values, PAD_Q, ids past the vocabulary, empty queries, a term every query holds), and
    their layout is the kernel's: the pointer array i32[V * tiles + 1] ascending from 0, each run
    of (term, tile) ascending in query and inside its tile, and the records past the last pointer
    exactly the dropped slots."""
    col, val, _ = query_rows(nq, nnz, seed=nq)
    post = S.postings(col, val, V)
    assert isinstance(post, S.Postings) and (post.nq, post.v) == (nq, V)
    assert post.tiles == -(-nq // S.POST_TILE)
    assert post.ptr.dtype == torch.int32 and post.ptr.shape == (V * post.tiles + 1,)
    assert post.rec.dtype == torch.int32 and post.rec.shape == (col.numel(), 2)
    table = S.postings_table(post)
    want = S.densify_t(col, val, V)
    assert table.is_contiguous() and torch.equal(table, want)
    # bit for bit, so the sign of a zero too
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))
    ptr, rec = post.ptr.long(), post.rec.long()
    assert int(ptr[0]) == 0 and bool((ptr[1:] >= ptr[:-1]).all())
    kept = int(((col >= 1) & (col <= V)).sum())
    assert int(ptr[-1]) == kept
    for key in range(V * post.tiles):
        run = rec[ptr[key]:ptr[key + 1], 0]
        tile = key % post.tiles
        assert bool((run[1:] > run[:-1]).all())
        assert bool(((run >= tile * S.POST_TILE) & (run < (tile + 1) * S.POST_TILE)).all())
    # id 3: every non-empty query holds it
    held = int(ptr[(2 + 1) * post.tiles] - ptr[2 * post.tiles])
    assert held == int((col[:, 0] != S.PAD_Q).sum())
    # the kernel's spans: each run's start, length and first two records (queries less the tile's
    # first), an empty run at the end
    span = post.span.long()
    assert post.span.dtype == torch.int32 and post.span.shape == (V * post.tiles + 1, 4)
    assert post.span.is_contiguous()
    n = ptr[1:] - ptr[:-1]
    assert torch.equal(span[:-1, 0], ptr[:-1]) and torch.equal(span[:-1, 1] & 0xFF, n)
    assert int(span[-1, 0]) == kept and not bool(span[-1, 1:].any())
    base = (torch.arange(n.shape[0]) % post.tiles) * S.POST_TILE
    for j, bits, col in ((0, 8, 2), (1, 16, 3)):
        has = n > j
        first = rec[span[:-1, 0][has] + j]
        assert torch.equal(span[:-1][has, 1] >> bits & 31, first[:, 0] - base[has])
        assert torch.equal(span[:-1][has, col].int(), first[:, 1].int())
        assert not bool((span[:-1][~has, 1] >> bits & 31).any()) and not bool(span[:-1][~has, col].any())


def postings_model(form, post, xcol, w, qn, qlen, xlen, pad):
    """The new kernel's arithmetic in f32 on the CPU: each row's real slots in order; at each, the
    records of the slot's id in every tile, one fused multiply-add a record into sum[query, row]
    (the records of one slot are distinct pairs); a non-finite weight multiplies every query's
    value of the id, 0 where it lacks it; padding adds nothing; the row's squares over its real
    slots in order; then the post and pad."""
    c, nnz = xcol.shape
    real = (xcol >= 1) & (xcol < S.PAD_X)
    w = real.float() if form == "jaccard" else torch.where(real, w, 0.0)
    ptr, rec = post.ptr.long(), post.rec
    qv = rec[:, 1].view(torch.float32)
    acc = torch.zeros((post.nq, c), dtype=torch.float32)
    xs = torch.zeros(c, dtype=torch.float32)
    rows = torch.arange(c)
    for t in range(nnz):
        term = (torch.clamp(xcol[:, t], 1, post.v).long() - 1)
        beg, end = ptr[term * post.tiles], ptr[(term + 1) * post.tiles]
        fin = torch.isfinite(w[:, t])
        n = torch.where(real[:, t] & fin, end - beg, 0)
        r = rows.repeat_interleave(n)
        j = torch.arange(int(n.sum())) - (torch.cumsum(n, 0) - n).repeat_interleave(n) + beg.repeat_interleave(n)
        q = rec[j, 0].long()
        acc[q, r] = torch.addcmul(acc[q, r], qv[j], w[r, t])
        for i in torch.nonzero(real[:, t] & ~fin)[:, 0].tolist():
            dense = torch.zeros(post.nq)
            run = slice(int(beg[i]), int(end[i]))
            dense[rec[run, 0].long()] = qv[run]
            acc[:, i] = torch.addcmul(acc[:, i], dense, w[i, t].expand(post.nq))
        xs = torch.where(real[:, t], torch.addcmul(xs, w[:, t], w[:, t]), xs)
    if form == "jaccard":
        return S.jaccard_from_counts(acc, qlen[:, None], xlen[None, :]) + pad[None, :]
    return S.dot_post(form, acc, qn[:, None], torch.sqrt(xs)[None, :]) + pad[None, :]


def _corpus_queries():
    xs = sparse_like(201, vocab=600, nnz=16, n_clusters=12, seed=41) + [
        (np.zeros(0, np.int32), np.zeros(0, np.float32)),
        (np.array([3, 9, 400], np.int32), np.zeros(3, np.float32)),
        (np.arange(1, 72, 3, dtype=np.int32), np.linspace(0.5, 2.0, 24).astype(np.float32))]
    qs = sparse_like(137, vocab=600, nnz=24, n_clusters=12, seed=42)
    qs += [(np.zeros(0, np.int32), np.zeros(0, np.float32)),
           (np.array([650, 690], np.int32), np.ones(2, np.float32))]
    return xs, qs


@pytest.mark.parametrize("name", list(NAMES))
def test_model_equals_the_dense_kernel_model(name):
    """On finite data the postings walk's f32 model equals the earlier kernel's model (every slot's
    product with the densified table, zeros included) tensor for tensor, and the plain version
    within the tolerance (exactly for the integer sums)."""
    xs, qs = _corpus_queries()
    ts, qenc, xc, ref = encode_both(name, xs, qs)
    args = qdense_args(name, qenc, xc)
    got = postings_model(*args)
    assert torch.equal(got, kernel_model(*table_args(args)))
    plain = S.qdense_dists_reference(*args)
    if NAMES[name][1]:
        assert torch.equal(got, plain)
    elif name.startswith("angulardist"):
        np.testing.assert_allclose(np.cos(got.double().numpy()), np.cos(plain.double().numpy()), atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


def _nonfinite_corpus():
    rows = sparse_like(90, vocab=600, nnz=24, n_clusters=12, seed=43)
    out = []
    for r, (ids, vals) in enumerate(rows):
        vals = vals.copy()
        if r % 6 == 1 and ids.size:
            vals[r % ids.size] = (np.inf, -np.inf, np.nan)[(r // 6) % 3]
        out.append((ids, vals))
    return out


@pytest.mark.parametrize("name", ["cosinesimil_sparse", "negdotprod_sparse", "querynorm_negdotprod_sparse",
                                  "angulardist_sparse"])
def test_nonfinite_weights_match_the_plain_version_and_tpu_knn(name):
    """Rows holding a +inf, -inf or NaN value: the model's NaN cells are exactly the plain
    version's and tpu_knn's block's (0 * inf for every query that lacks the id), and its other
    cells (+-inf among them) equal theirs within the tolerance."""
    xs, (_, qs) = _nonfinite_corpus(), _corpus_queries()
    ts, qenc, xc, ref = encode_both(name, xs, qs)
    args = qdense_args(name, qenc, xc)
    got = postings_model(*args).numpy()
    plain = S.qdense_dists_reference(*args).numpy()
    assert np.isnan(got).any()
    for other in (plain, ref):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other))
        keep = ~np.isnan(got)
        if name.startswith("angulardist"):
            np.testing.assert_allclose(np.cos(got[keep].astype(np.float64)), np.cos(other[keep].astype(np.float64)),
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(got[keep], other[keep], rtol=RTOL, atol=ATOL)


def test_scan_attaches_postings_and_slices_rebuild_them():
    """A scan attaches postings once (no [V, Q] table), reuses them for the same batch and width,
    rebuilds them for another width; _slice_qenc passes them whole and the block of a sliced batch
    rebuilds its own, whose distances are the full batch's rows (within the tolerance: the plain
    version's batched product sums in an order that depends on the query count)."""
    xs, qs = _corpus_queries()
    ts = t_create_space("cosinesimil_sparse", tpu_knn_torch.Params(), device="cpu")
    st = TDataStore(TDataKind.SPARSE)
    st.add_sparse_batch(xs)
    data = ts.encode_dataset(st)
    xc = ts.slice_data(data, 0, data.ids.shape[0])
    qenc = ts.densify_queries(ts.encode_queries(qs), xc, scan=True)
    assert "q_post" in qenc and "q_dense_t" not in qenc and "qnorm" in qenc
    assert ts.densify_queries(qenc, xc, scan=True)["q_post"] is qenc["q_post"]
    wider = ts.densify_queries(qenc, {"vocab_mark": torch.zeros(1024, dtype=torch.int8)}, scan=True)
    assert wider["q_post"].v == 1024
    full = ts.block(qenc, xc)
    nq = len(qs)
    part = _slice_qenc(qenc, nq, 10, 40)
    assert part["q_post"] is qenc["q_post"] and part["qcol"].shape[0] == 30
    np.testing.assert_allclose(ts.block(part, xc).numpy(), full[10:40].numpy(), rtol=RTOL, atol=ATOL)


def test_jaccard_and_binary_postings_hold_presence():
    """Jaccard's postings hold 1.0 for every id a query holds (zero values included), a _bin_fast
    name's its 0/1 values; both densify to densify_t of the same values."""
    col, val, _ = query_rows(50, 16, seed=5)
    for name in ("sparse_jaccard", "negdotprod_sparse_bin_fast"):
        ts = t_create_space(name, tpu_knn_torch.Params(), device="cpu")
        values = ts._qdense_values((val != 0).float() if name.endswith("bin_fast") else val)
        post = S.postings(col, values, V)
        kept = post.rec[:int(post.ptr[-1]), 1].view(torch.float32)
        if name == "sparse_jaccard":
            assert bool((kept == 1.0).all())
        else:
            assert bool(((kept == 0.0) | (kept == 1.0)).all()) and bool((kept == 0.0).any())
        assert torch.equal(S.postings_table(post), S.densify_t(col, values, V))


def test_qdense_dists_takes_postings_of_its_own_shapes():
    """The wrapper refuses postings whose pointers do not match their vocabulary and tile count, or
    whose query count differs from the norms'."""
    xs, qs = _corpus_queries()
    _, qenc, xc, _ = encode_both("cosinesimil_sparse", xs, qs)
    form, post, xcol, w, qn, qlen, xlen, pad = qdense_args("cosinesimil_sparse", qenc, xc)
    with pytest.raises(ValueError, match="post.ptr"):
        S.qdense_dists(form, dataclasses.replace(post, v=post.v + 128), xcol, w, qn, qlen, xlen, pad)
    with pytest.raises(ValueError, match="qn"):
        S.qdense_dists(form, post, xcol, w, qn[:-1], qlen, xlen, pad)
    with pytest.raises(ValueError, match="post.rec"):
        S.qdense_dists(form, dataclasses.replace(post, rec=post.rec.long()), xcol, w, qn, qlen, xlen, pad)


def test_jaccard_block_equals_tpu_knn_on_presence_postings():
    """sparse_jaccard's block through the postings equals tpu_knn's, cell for cell (integer counts)."""
    xs, qs = _corpus_queries()
    js = j_create_space("sparse_jaccard", tpu_knn.Params())
    jst = DataStore(DataKind.SPARSE)
    jst.add_sparse_batch(xs)
    jd = js.encode_dataset(jst)
    ts, qenc, xc, ref = encode_both("sparse_jaccard", xs, qs)
    np.testing.assert_array_equal(ts.block(qenc, xc).numpy(),
                                  np.asarray(js.block(js.encode_queries(qs), js.slice_data(jd, 0, xc["cols"].shape[0]))))


def test_ablation_tool_patches_apply():
    """Every text patch of tools/sparse_qdense_ablation.py finds its line in the kernel's source,
    once (the tool builds its variants from them on the card)."""
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.tools import sparse_qdense_ablation as A

    src = GM.SOURCES["sparse_qdense"].read_text()
    assert set(A.VARIANTS) >= {"full", "no_walk", "no_post", "no_store", "no_rare", "no_gathers"}
    for name, patches in A.VARIANTS.items():
        for old, new in patches:
            assert src.count(old) == 1, (name, old)
            assert new != old
