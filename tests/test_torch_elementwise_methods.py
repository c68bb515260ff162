"""l1, lp (p=3) and jsdivfast through every method whose scorers take the elementwise kernel's
wrappers (tpu_knn_torch/ops/elementwise.py; on the CPU their plain versions): seq_search on the
two-pass route (pass 2 through the batched epilogue), HNSW and sw-graph (the beam, the wave mates,
the heuristic's pairs), VP-tree and NAPP (both query routes each), held against tpu_knn on the
same 2,000 Dirichlet(0.1) histograms: ids equal except on ties, distances within rtol 5e-3 /
atol 1e-5. The graph methods' cases are in tests/test_torch_elementwise_hnsw.py and
tests/test_torch_elementwise_swgraph.py (each file runs on one test worker: the CPU's plain JS at
2,000 rows takes minutes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
NAMES = {"l1": {}, "lp": {"p": 3.0}, "jsdivfast": {}}
#: method -> (build parameters, the query-time parameters of each route it is held on)
METHODS = {
    "seq_search": ({"chunkSize": 12288}, [{}]),  # 2,000 rows padded to 12,288: two passes
    "hnsw": ({"M": 8, "efConstruction": 20, "waveSize": 128}, [{"efSearch": 40}]),
    "sw-graph": ({"NN": 8, "efConstruction": 20, "waveSize": 128}, [{"efSearch": 40}]),
    "vptree": ({"bucketSize": 40}, [{}, {"alphaLeft": 2.0, "alphaRight": 2.0, "maxLeavesToVisit": 6}]),
    "napp": ({"numPivot": 64, "numPrefix": 8}, [{"minTimes": 2, "invProcAlg": "scan"},
                                                {"minTimes": 2, "invProcAlg": "gather"}]),
}


def _data():
    a = np.random.default_rng(81).dirichlet(np.full(24, 0.1), 2040).astype(np.float32)
    return a[:2000], a[2000:]


def _assert_same_knn(ref, got):
    """Distances within the tolerance; an id that differs is in the reference's row or ties the
    reference's distance at its slot."""
    (d1, i1), (d2, i2) = ref, got
    assert d1.shape == d2.shape and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    for r, c in zip(*np.nonzero(i1 != i2)):
        assert i2[r, c] in set(i1[r]) or np.isclose(d2[r, c], d1[r, c], rtol=RTOL, atol=ATOL), (r, c)


def check_method(name, method):
    """``name`` through ``method`` in both packages, built alike on the same rows: kNN at k=10 on
    each of the method's routes, ids equal except on ties."""
    x, q = _data()
    build, routes = METHODS[method]
    idxs = []
    for pkg in (tpu_knn, tpu_knn_torch):
        idx = pkg.Index(name, pkg.Params(NAMES[name]), method=method,
                        **({"device": "cpu"} if pkg is tpu_knn_torch else {}))
        idx.add_dense_batch(x)
        idx.build_index(pkg.Params(build))
        idxs.append(idx)
    j, t = idxs
    for params in routes:
        j.set_query_time_params(tpu_knn.Params(params))
        t.set_query_time_params(tpu_knn_torch.Params(params))
        _assert_same_knn(j.knn_query_batch(q, 10), t.knn_query_batch(q, 10))
    if method == "seq_search":
        assert t.method.last_route == "twopass"


@pytest.mark.parametrize("method", ["napp", "seq_search", "vptree"])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_method_matches_tpu_knn(name, method):
    check_method(name, method)
