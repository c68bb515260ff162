"""The SQFD spaces and sparse_dense_fusion in the port (device="cpu"), held
against tpu_knn on the same seeded numpy inputs: tests/test_string_spaces.py's
test_sparse_dense_fusion, test_sqfd, test_fusion_index_weights_used_in_construction
and test_fusion_weight_validation replayed on the port, and each space's
``block``, gathered and pair scorers, kNN and files against tpu_knn.

Tolerances are ROADMAP.md's: distances rtol 5e-3 and atol 1e-5, ids equal
except on ties."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn.core.dataset import DataStore as JStore  # noqa: E402
from tpu_knn.core.registry import create_space as jspace  # noqa: E402
from tpu_knn_torch import DataKind, Index, Params  # noqa: E402
from tpu_knn_torch.core.dataset import DataStore  # noqa: E402
from tpu_knn_torch.core.registry import create_space  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402
from tpu_knn_torch.methods.hnsw import _score_pairs  # noqa: E402
from tpu_knn_torch.ops import graph as G  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
SQFD = {
    "sqfd_minus_func": lambda d: -d,
    "sqfd_heuristic_func": lambda d: 1.0 / (1.0 + d),
    "sqfd_gaussian_func": lambda d: np.exp(-1.0 * d * d),
}


def _sig(rng, nc, d=4):
    return {"weights": [float(x) for x in rng.random(nc)],
            "centers": [[float(v) for v in rng.standard_normal(d)] for _ in range(nc)]}


def _sigs(n, seed, d=4, lo=2, hi=6):
    rng = np.random.default_rng(seed)
    return [json.dumps(_sig(rng, int(rng.integers(lo, hi)), d)) for _ in range(n)]


def _sqfd_oracle(a, b, f):
    """W^T A W over the union of both signatures' centers, in float64."""
    a, b = json.loads(a), json.loads(b)
    w = np.concatenate([np.asarray(a["weights"]), -np.asarray(b["weights"])])
    c = np.concatenate([np.asarray(a["centers"]), np.asarray(b["centers"])])
    dd = np.sqrt(((c[:, None] - c[None, :]) ** 2).sum(-1))
    return float(np.sqrt(max(w @ f(dd) @ w, 0.0)))


def _fusion_objs(n, seed, d=8):
    """Objects of one d-wide dense and one sparse_like component."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, d)).astype(np.float32)
    sp = sparse_like(n, vocab=300, nnz=8, n_clusters=6, seed=seed)
    return [json.dumps({"dense": [dense[i].tolist()],
                        "sparse": [[np.asarray(ids).tolist(), np.asarray(vals, np.float64).tolist()]]})
            for i, (ids, vals) in enumerate(sp)]


def _blocks(name, params, xs, qs):
    """``block`` of both packages over the same corpus and queries."""
    out = []
    for create, store_cls, kw in ((jspace, JStore, {}), (create_space, DataStore, CPU)):
        space = create(name, params, **kw)
        store = store_cls(DataKind.STRING if store_cls is DataStore else tpu_knn.DataKind.STRING)
        store.add_string_batch(xs)
        data = space.encode_dataset(store)
        qenc = space.encode_queries(qs)
        d = space.block(qenc, space.slice_data(data, 0, data.ids.shape[0]))
        out.append(np.asarray(d) if not isinstance(d, torch.Tensor) else d.numpy())
    return out


#: a self-distance of SQFD is sqrt(s_a + s_b - 2 cross) at an f32 cancellation
#: of ~1e-6, so it reads 0 or ~1e-3 in either package: both at most this
#: count as the same zero
SQRT_FLOOR = 2e-3


def _same_knn(ref, got):
    (d1, i1), (d2, i2) = ref, got
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1) & ~((np.abs(d1) <= SQRT_FLOOR) & (np.abs(d2) <= SQRT_FLOOR))
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert np.isclose(d1[r, c], d2[r, c], rtol=RTOL, atol=ATOL) and i2[r, c] in set(i1[r]) | {
            i1[r, j] for j in np.nonzero(np.isclose(d1[r], d2[r, c], rtol=RTOL, atol=ATOL))[0]}, (r, c)


def test_sparse_dense_fusion():
    def obj(dense, ids, vals):
        return json.dumps({"dense": [list(map(float, dense))], "sparse": [[list(map(int, ids)), list(map(float, vals))]]})

    xs = [obj([1.0, 0.0], [1, 3], [1.0, 2.0]), obj([0.0, 1.0], [2, 3], [3.0, 1.0]), obj([0.5, 0.5], [1, 2], [1.0, 1.0])]
    idx = Index("sparse_dense_fusion", Params(indexWeights="1.0,1.0", queryWeights="0.5,2.0"), method="seq_search",
                data_type=DataKind.STRING, **CPU)
    idx.add_string_batch(xs)
    d, ids = idx.knn_query_batch([obj([1.0, 1.0], [3], [1.0])], 3)
    dots = [-(0.5 * 1.0 + 2.0 * 2.0), -(0.5 * 1.0 + 2.0 * 1.0), -(0.5 * 1.0 + 2.0 * 0.0)]
    assert list(ids[0]) == list(np.argsort(dots))
    assert np.allclose(sorted(dots), d[0], atol=1e-5)


def test_sqfd():
    """SQFD against a direct float64 W^T A W evaluation (space_sqfd.cc layout)."""
    sigs, qs = _sigs(5, 1), _sigs(2, 2, lo=3, hi=5)
    for name, f in SQFD.items():
        space = create_space(name, Params(alpha=1.0), **CPU)
        store = DataStore(DataKind.STRING)
        store.add_string_batch(sigs)
        data = space.encode_dataset(store)
        d = space.block(space.encode_queries(qs), space.slice_data(data, 0, data.ids.shape[0])).numpy()
        for i, q in enumerate(qs):
            for j, x in enumerate(sigs):
                assert d[i, j] == pytest.approx(_sqfd_oracle(q, x, f), rel=1e-3, abs=1e-3), name


@pytest.mark.parametrize("name", sorted(SQFD))
def test_sqfd_block_equals_tpu_knn(name):
    """Signatures of 2-12 clusters in d=5 (padded to 8): block within rtol
    5e-3 of tpu_knn's and of the float64 oracle."""
    xs, qs = _sigs(40, 3, d=5, lo=2, hi=13), _sigs(7, 4, d=5, lo=2, hi=13)
    ref, got = _blocks(name, {"alpha": 0.7}, xs, qs)
    np.testing.assert_allclose(got[:, :40], ref[:, :40], rtol=RTOL, atol=ATOL)
    assert (got[:, 40:] >= 1e29).all() and (ref[:, 40:] >= 1e29).all()
    f = {"sqfd_minus_func": lambda d: -d, "sqfd_heuristic_func": lambda d: 1.0 / (0.7 + d),
         "sqfd_gaussian_func": lambda d: np.exp(-0.7 * d * d)}[name]
    want = np.array([[_sqfd_oracle(q, x, f) for x in xs] for q in qs])
    np.testing.assert_allclose(got[:, :40], want, rtol=RTOL, atol=1e-4)


def test_fusion_block_equals_tpu_knn():
    xs, qs = _fusion_objs(60, 5), _fusion_objs(9, 6)
    ref, got = _blocks("sparse_dense_fusion", {"indexWeights": "1.0,2.0", "queryWeights": "0.5,3.0"}, xs, qs)
    np.testing.assert_allclose(got[:, :60], ref[:, :60], rtol=RTOL, atol=ATOL)


def _gathered_and_pairs(name, params, xs):
    """The gathered scorer and the pair scorer against ``block`` on the same
    rows: query i of the corpus against candidate rows ``cand[i]``."""
    space = create_space(name, params, **CPU)
    store = DataStore(DataKind.STRING)
    store.add_string_batch(xs)
    data = space.encode_dataset(store)
    corpus = space.corpus_dict(data)
    qenc = space.encode_queries(xs)
    full = space.block(qenc, space.slice_data(data, 0, data.ids.shape[0]))
    n = len(xs)
    cand = torch.from_numpy(np.random.default_rng(9).integers(-1, n, (n, 7)).astype(np.int32))
    got = G.score_rows(space, qenc, corpus, cand)
    want = torch.where(cand < 0, float("inf"), full.gather(1, cand.clamp(0).long()))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    pairs = _score_pairs(space, qenc, n, corpus, cand[:, :3], cand)
    want_p = torch.where((cand[:, :3, None] < 0) | (cand[:, None, :] < 0), float("inf"),
                         full[cand[:, :3].clamp(0).long()[:, :, None], cand.clamp(0).long()[:, None, :]])
    torch.testing.assert_close(pairs, want_p, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["sqfd_heuristic_func", "sparse_dense_fusion"])
def test_gathered_and_pair_scorers_equal_block(name):
    xs = _sigs(30, 7, d=3, lo=1, hi=9) if name.startswith("sqfd") else _fusion_objs(30, 8)
    _gathered_and_pairs(name, {} if name.startswith("sqfd") else {"indexWeights": "1,1", "queryWeights": "1,1"},
                        xs)


@pytest.mark.parametrize("name,method", [("sqfd_gaussian_func", "seq_search"), ("sqfd_gaussian_func", "hnsw"),
                                         ("sparse_dense_fusion", "seq_search"), ("sparse_dense_fusion", "hnsw")])
def test_knn_and_files_equal_tpu_knn(tmp_path, name, method):
    """kNN of both packages on 240 objects (HNSW: M=6, efConstruction=30),
    and a file each package saves loaded by the other with the same answers."""
    xs = _sigs(240, 11, d=4, lo=2, hi=7) if name.startswith("sqfd") else _fusion_objs(240, 12)
    qs = xs[:12]
    params = {"alpha": 0.5} if name.startswith("sqfd") else {"indexWeights": "1.0,1.5", "queryWeights": "1.0,1.5"}
    res, idxs = [], []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, CPU)):
        idx = pkg.Index(name, pkg.Params(params), method=method, data_type="object_as_string", **kw)
        idx.add_string_batch(xs)
        idx.build_index(pkg.Params(M=6, efConstruction=30, waveSize=32) if method == "hnsw" else None)
        if method == "hnsw":
            idx.set_query_time_params(pkg.Params(efSearch=60))
        res.append(idx.knn_query_batch(qs, 5))
        idxs.append(idx)
    _same_knn(res[0], res[1])
    if method == "hnsw":
        np.testing.assert_array_equal(np.asarray(idxs[0].method.graph["level0"]),
                                      idxs[1].method.graph["level0"].numpy())
    for src, dst, kw in ((idxs[0], tpu_knn_torch, CPU), (idxs[1], tpu_knn, {})):
        p = str(tmp_path / f"x_{dst.__name__}")
        src.save(p)
        back = dst.Index.load(p, **kw)
        if method == "hnsw":
            back.set_query_time_params(dst.Params(efSearch=60))
        _same_knn(src.knn_query_batch(qs, 5), back.knn_query_batch(qs, 5))


def test_fusion_index_weights_used_in_construction():
    """indexWeights score index-time distances, queryWeights score queries
    (reference compDistance(isQueryTime))."""
    rng = np.random.default_rng(13)

    def obj(dense, ids, vals):
        return json.dumps({"dense": [list(map(float, dense))], "sparse": [[list(map(int, ids)), list(map(float, vals))]]})

    xs = [obj(rng.standard_normal(2), [1, 2], rng.random(2) + 0.1) for _ in range(8)]
    space = create_space("sparse_dense_fusion", Params(indexWeights="1.0,0.0", queryWeights="0.0,1.0"), **CPU)
    store = DataStore(DataKind.STRING)
    store.add_string_batch(xs)
    data = space.encode_dataset(store)
    xc = space.slice_data(data, 0, data.ids.shape[0])
    qenc = space.encode_queries(xs[:2])
    dq = space.block(qenc, xc).numpy()  # query weights
    di = space.construction_space().block(qenc, xc).numpy()  # index weights
    assert not np.allclose(dq[:, :8], di[:, :8])
    dense_q = np.stack([json.loads(x)["dense"][0] for x in xs[:2]])
    dense_x = np.stack([json.loads(x)["dense"][0] for x in xs])
    np.testing.assert_allclose(di[:, :8], -(dense_q @ dense_x.T), atol=1e-5)
    idx = Index("sparse_dense_fusion", Params(indexWeights="1.0,0.0", queryWeights="0.0,1.0"), method="hnsw",
                data_type=DataKind.STRING, **CPU)
    idx.add_string_batch(xs)
    idx.build_index(Params(M=4, efConstruction=8, waveSize=8))
    d, i = idx.knn_query_batch(xs[:2], 2)
    assert i.shape == (2, 2)


def test_fusion_weight_validation(tmp_path):
    x = json.dumps({"dense": [[1.0, 0.0]], "sparse": [[[1], [1.0]]]})
    # compDistance skips weights <= FLT_MIN: a negative weight drops its component
    idx = Index("sparse_dense_fusion", Params(indexWeights="1.0,1.0", queryWeights="1.0,-1.0"),
                method="seq_search", data_type=DataKind.STRING, **CPU)
    idx.add_string_batch([x])
    d, _ = idx.knn_query_batch([x], 1)
    assert abs(d[0][0] - (-1.0)) < 1e-5
    extra = Index("sparse_dense_fusion", Params(indexWeights="1.0,1.0,9.0", queryWeights="1.0,1.0,9.0"),
                  method="seq_search", data_type=DataKind.STRING, **CPU)
    extra.add_string_batch([x])
    d2, _ = extra.knn_query_batch([x], 1)
    assert abs(d2[0][0] - (-2.0)) < 1e-5
    few = Index("sparse_dense_fusion", Params(indexWeights="1.0", queryWeights="1.0"), method="seq_search",
                data_type=DataKind.STRING, **CPU)
    few.add_string_batch([x])
    with pytest.raises(Exception, match="[Tt]oo few"):
        few.knn_query_batch([x], 1)
    y = json.dumps({"dense": [[1.0, 0.0], [2.0, 2.0]], "sparse": [[[1], [1.0]]]})
    mixed = Index("sparse_dense_fusion", Params(), method="seq_search", data_type=DataKind.STRING, **CPU)
    mixed.add_string_batch([x, y])
    with pytest.raises(Exception, match="differing component counts"):
        mixed.knn_query_batch([x], 1)
    # a weight file in the reference's format, and its errors
    wf = tmp_path / "w.txt"
    wf.write_text("queryWeights: 0.5,2.0\nindexWeights: 1.0,1.0\n")
    sp = create_space("sparse_dense_fusion", Params(weightfile=str(wf)), **CPU)
    assert sp.query_weights == [0.5, 2.0] and sp.index_weights == [1.0, 1.0]
    wf.write_text("queryWeights: 0.5\nindexWeights: 1.0,1.0\n")
    with pytest.raises(Exception, match="non-matching"):
        create_space("sparse_dense_fusion", Params(weightfile=str(wf)), **CPU)
    with pytest.raises(Exception, match="both indexWeights and queryWeights"):
        create_space("sparse_dense_fusion", Params(indexWeights="1.0"), **CPU)
