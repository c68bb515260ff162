"""The port's NN-descent pieces (tpu_knn_torch/ops/nndescent.py, device="cpu")
against tpu_knn's (tpu_knn/ops/nndescent.py) on the same numpy inputs.

The sort and group pieces and the host BFS are bit-equal. Scores are
within rtol 5e-3, atol 1e-5. The k-NN graph, the pruned adjacency and the
upper levels hold tpu_knn's neighbour sets in at least 0.99 of rows (the
share found is printed): their exact distances are f32 sums in another
order, so a near tie can order two rows differently. Sizes are those of
tests/test_nndescent.py. Whole builds in the other spaces and with the f32
scoring copy are here too, with the helpers of tests/test_torch_hnsw_nnd.py
(which holds the l2 build, its modes and routing), so the two files take
about as long each."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import tpu_knn  # noqa: E402
import tpu_knn.ops.nndescent as JN  # noqa: E402
import tpu_knn_torch  # noqa: E402
import tpu_knn_torch.ops.nndescent as TN  # noqa: E402
from tpu_knn.core.dataset import DataKind as JKind  # noqa: E402
from tpu_knn.core.dataset import DataStore as JStore  # noqa: E402
from tpu_knn.core.registry import create_space as j_space  # noqa: E402
from tpu_knn.eval.datasets import sift_like  # noqa: E402
from tpu_knn_torch.core.dataset import DataKind as TKind  # noqa: E402
from tpu_knn_torch.core.dataset import DataStore as TStore  # noqa: E402
from tpu_knn_torch.core.registry import create_space as t_space  # noqa: E402
from test_torch_hnsw_nnd import NND, _check_against_tpu_knn, _index, _sift_u8  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
N, DIM = 1024, 32
KNN = dict(k=24, krev=8, t_keep=8, chunk=1024, seed=0, n_random=8)


def _pair(space, x):
    """(tpu_knn space, corpus dict), (port space, corpus dict) over x."""
    kind = "UINT8" if x.dtype == np.uint8 else "DENSE"
    out = []
    for create, store_cls, kinds, kw in ((j_space, JStore, JKind, {}), (t_space, TStore, TKind, {"device": "cpu"})):
        sp = create(space, **kw)
        st = store_cls(getattr(kinds, kind))
        (st.add_uint8_batch if kind == "UINT8" else st.add_dense_batch)(x)
        out.append((sp, sp.corpus_dict(sp.encode_dataset(st))))
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _set_share(a, b, n):
    return float(np.mean([set(r) == set(s) for r, s in zip(_np(a)[:n], _np(b)[:n])]))


@pytest.fixture(scope="module")
def l2():
    return _pair("l2", sift_like(N + 128, DIM, seed=3)[:N])


@pytest.fixture(scope="module")
def knn_graphs(l2):
    """build_knn_graph in both packages (5 sweeps)."""
    (js, jc), (ts, tc) = l2
    return JN.build_knn_graph(js, jc, N, iters=5, **KNN), TN.build_knn_graph(ts, tc, N, iters=5, **KNN)


# ---------------- the sort and group pieces: bit-equal ----------------


def _random_adj(rng, s_rows, k, n, p_neg=0.1):
    adj = rng.integers(0, n, size=(s_rows, k)).astype(np.int32)
    adj[rng.random(adj.shape) < p_neg] = -1
    adj[n:] = -1
    return adj


@pytest.mark.parametrize("s_rows,k,krev,count", [(256, 12, 4, 256), (300, 8, 8, 250), (64, 3, 16, 64)])
def test_make_b_is_bit_equal(s_rows, k, krev, count):
    adj = _random_adj(np.random.default_rng(s_rows), s_rows, k, count)
    want = np.asarray(JN._make_b(jnp.asarray(adj), krev, count))
    got = TN._make_b(torch.from_numpy(adj), krev, count)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_dedup_sorted_is_bit_equal():
    """Duplicate ids carrying different distances keep the least; INF and
    -1 entries drop out; ties in distance order by id."""
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 40, size=(64, 50)).astype(np.int32)
    d = rng.integers(0, 30, size=(64, 50)).astype(np.float32) / 4  # many exact ties
    d[rng.random(d.shape) < 0.1] = np.inf
    ids[:, 7] = ids[:, 3]  # the same id twice, with two distances
    d[:, 7] = d[:, 3] + 0.5
    for k in (10, 50):
        wd, wi = JN._merge_dedup_sorted(jnp.asarray(d), jnp.asarray(ids), k)
        gd, gi = TN._merge_dedup_sorted(torch.from_numpy(d), torch.from_numpy(ids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        assert gi.dtype == torch.int32


@pytest.mark.parametrize("krev", [4, 32])
def test_rev_nearest_is_bit_equal(krev):
    rng = np.random.default_rng(krev)
    sel = _random_adj(rng, 300, 16, 280)
    seld = rng.integers(0, 50, size=sel.shape).astype(np.float32) / 8
    seld[sel < 0] = np.inf
    wr, wd = JN._rev_nearest(jnp.asarray(sel), jnp.asarray(seld), krev, 280)
    gr, gd = TN._rev_nearest(torch.from_numpy(sel), torch.from_numpy(seld), krev, 280)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("cap", [8, 16, 32])
def test_reverse_fill_is_bit_equal(cap):
    rng = np.random.default_rng(cap)
    sel = _random_adj(rng, 256, 8, 240)
    want = np.asarray(JN._reverse_fill(jnp.asarray(sel), cap, 240))
    np.testing.assert_array_equal(TN._reverse_fill(torch.from_numpy(sel), cap, 240).numpy(), want)


def test_reach_from_host_is_bit_equal():
    """tests/test_nndescent.py's graph, and random sparse graphs from
    several entries."""
    adj = np.array([[1, -1, -1], [2, 0, -1], [-1, -1, -1], [4, -1, -1], [3, -1, -1], [-1, -1, -1]], np.int32)
    assert TN._reach_from_host(adj, 0).tolist() == [True, True, True, False, False, False]
    rng = np.random.default_rng(5)
    for entry in (-1, 0, 3, 5, 99):
        np.testing.assert_array_equal(TN._reach_from_host(adj, entry), JN._reach_from_host(adj, entry))
    for seed in range(4):
        g = _random_adj(np.random.default_rng(seed), 500, 2, 500, p_neg=0.5)
        for entry in (0, int(rng.integers(0, 500))):
            np.testing.assert_array_equal(TN._reach_from_host(g, entry), JN._reach_from_host(g, entry))


# ---------------- scoring: within tolerance ----------------


@pytest.mark.parametrize("space", ["l2", "cosinesimil", "l2sqr_sift"])
def test_score_from_rows_and_pairs_match(space):
    rng = np.random.default_rng(2)
    if space == "l2sqr_sift":
        x = rng.integers(0, 256, size=(200, 128)).astype(np.uint8)
    else:
        x = sift_like(200, DIM, seed=4)
    (js, jc), (ts, tc) = _pair(space, x)
    jv, tv = jc["vecs"], tc["vecs"]
    np.testing.assert_array_equal(_np(jv), tv.numpy())
    cand = rng.integers(0, 200, size=(16, 6, 5)).astype(np.int32)
    for xscale in ((1.0,) if space == "l2sqr_sift" else (1.0, 0.37)):
        rows_j, rows_t = jv[cand], tv[torch.from_numpy(cand).long()]
        if xscale != 1.0:  # an int8 store of the rows, as the descent keeps it
            rows_j = jnp.clip(jnp.round(rows_j / xscale), -127, 127).astype(jnp.int8)
            rows_t = torch.from_numpy(np.array(rows_j))
        want = np.asarray(JN._score_from_rows(js, js.rows_as_queries(jv[:16]), rows_j, xscale))
        got = TN._score_from_rows(ts, ts.rows_as_queries(tv[:16]), rows_t, xscale)
        assert got.shape == (16, 6, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    rows = np.argsort(rng.random((16, 200)), axis=1)[:, :5].astype(np.int32)  # distinct ids a row
    want = np.asarray(JN.pairs_from_rows(js, jv[rows]))
    got = TN.pairs_from_rows(ts, tv[torch.from_numpy(rows).long()]).numpy()
    assert got.shape == (16, 5, 5)
    # off the diagonal: a row's own pair is the norm identity's cancellation
    # residue (sqrt of a rounding error), which the selection never reads
    off = ~np.eye(5, dtype=bool)[None].repeat(16, 0)
    np.testing.assert_allclose(got[off], want[off], rtol=RTOL, atol=ATOL)


# ---------------- the entry points: tpu_knn's neighbour sets ----------------


def test_build_knn_graph_holds_tpu_knn_lists(knn_graphs):
    (jd, ja), (td, ta) = knn_graphs
    assert ta.shape == (N, 24 + 8) and ta.dtype == torch.int32 and td.dtype == torch.float32
    share = _set_share(ja, ta, N)
    print(f"k-NN rows with tpu_knn's neighbour set: {share:.4f}")
    # found 1.0 on x86-64
    assert share >= 0.99
    fin = np.isfinite(_np(jd))
    np.testing.assert_array_equal(fin, np.isfinite(td.numpy()))
    np.testing.assert_allclose(td.numpy()[fin], _np(jd)[fin], rtol=RTOL, atol=1e-3)
    assert (np.diff(td.numpy()[:, :24], axis=1)[fin[:, 1:24]] >= 0).all()  # ascending


@pytest.mark.parametrize("rev_mode", ["shrink", "slots"])
def test_prune_and_link_holds_tpu_knn_sets(l2, knn_graphs, rev_mode):
    """Both reverse modes on the same k-NN lists (tpu_knn's)."""
    (js, jc), (ts, tc) = l2
    (jd, ja), _ = knn_graphs
    kw = dict(m=8, cap=16, chunk=1024, rev_mode=rev_mode)
    want = JN.prune_and_link(js, jc, jd, ja, N, **kw)
    got = TN.prune_and_link(ts, tc, torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ja)), N, **kw)
    assert got.shape == (N, 16) and got.dtype == torch.int32
    share = _set_share(want, got, N)
    print(f"{rev_mode}: adjacency rows with tpu_knn's neighbour set: {share:.4f}")
    assert share >= 0.99


def test_build_level_exact_holds_tpu_knn_sets(l2):
    (js, jc), (ts, tc) = l2
    for n_l in (2, 117, 300):
        kw = dict(m=8, cap=8, k_cand=min(64, n_l - 1), chunk=min(2048, n_l), n_random=8, seed=0)
        want = JN.build_level_exact(js, jc, n_l, **kw)
        got = TN.build_level_exact(ts, tc, n_l, **kw)
        assert got.shape == (n_l, 8)
        assert _set_share(want, got, n_l) >= 0.99, n_l


def test_repair_reachability_matches_tpu_knn(l2):
    """Two clusters of a graph that never link across: the repair links the
    far one back, as tpu_knn does."""
    (js, jc), (ts, tc) = l2
    rng = np.random.default_rng(8)
    adj = np.full((N, 16), -1, np.int32)
    half = N // 2
    adj[:half, :8] = rng.integers(0, half, size=(half, 8))
    adj[half:, :8] = rng.integers(half, N, size=(N - half, 8))
    want, nj = JN.repair_reachability(js, jc, jnp.asarray(adj), N, entry=0, chunk=256)
    got, nt = TN.repair_reachability(ts, tc, torch.from_numpy(adj), N, entry=0, chunk=256)
    assert nt == nj > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TN._reach_from_host(got.numpy(), 0)[:N].all()


def test_wide_row_mode_equals_the_store(monkeypatch):
    """Rows of >= 512 bytes skip the replicated neighbourhood store and
    gather candidate rows directly; the graph is bit-identical
    (tests/test_nndescent.py's case)."""
    rng = np.random.default_rng(0)
    n, d = 600, 512  # d * int8 = 512 B -> wide-row path
    x = rng.standard_normal((n, d)).astype(np.float32)
    (_, _), (ts, tc) = _pair("l2", x)
    kw = dict(k=8, iters=3, krev=8, t_keep=8, chunk=128, seed=3)
    calls = []
    store = TN._gather_store
    monkeypatch.setattr(TN, "_gather_store", lambda xq, b: calls.append(1) or store(xq, b))
    d1, a1 = TN.build_knn_graph(ts, tc, n, **kw)
    assert not calls  # the wide-row path ran
    # force the store path by raising the wide threshold out of reach
    monkeypatch.setattr(TN, "WIDE_ROW_BYTES", 10**9)
    d2, a2 = TN.build_knn_graph(ts, tc, n, **kw)
    assert calls  # the store path ran
    assert torch.equal(a1, a2) and torch.equal(d1, d2)


# ---------------- whole builds: the other spaces, the f32 scoring copy ----------------


@pytest.fixture(scope="module")
def data():
    pts = sift_like(N + 128, DIM, seed=3)
    return pts[:N], pts[N:]


def test_cosine_build_matches_tpu_knn(data):
    corpus, q = data
    jidx, tidx = (_index(pkg, "cosinesimil", corpus, NND) for pkg in (tpu_knn, tpu_knn_torch))
    _check_against_tpu_knn(jidx, tidx, corpus, q, "cosinesimil", "cosinesimil")


def test_sift_u8_build_matches_tpu_knn():
    """l2sqr_sift: int8 rows, exact integer scores, xscale 1."""
    pts = _sift_u8()
    corpus, q = pts[:N], pts[N:]
    jidx, tidx = (_index(pkg, "l2sqr_sift", corpus, NND) for pkg in (tpu_knn, tpu_knn_torch))
    _check_against_tpu_knn(jidx, tidx, corpus, q, "l2sqr_sift", "l2sqr_sift")
    tidx.set_query_time_params(tpu_knn_torch.Params(efSearch=50))
    res = tidx.knn_query(corpus[5], k=3)
    assert res.ids[0] == 5 and res.dists[0] == 0 and np.all(res.dists == np.rint(res.dists))


def test_f32_scoring_copy_matches_tpu_knn(data):
    """nndStoreDtype="float32": the descent scores f32 rows rounded to bf16
    (128 bytes a row at D=32, so still through the store)."""
    corpus, q = data
    mode = dict(NND, nndStoreDtype="float32")
    jidx, tidx = (_index(pkg, "l2", corpus, mode) for pkg in (tpu_knn, tpu_knn_torch))
    _check_against_tpu_knn(jidx, tidx, corpus, q, "l2", "nndStoreDtype=float32")
