"""Non-blocking knn_query_batch_async in the port (device="cpu"): the
in-order dispatcher of methods/base.py, held against tpu_knn's futures on
the same seeded numpy inputs.

Futures of seq_search (l2 on both routes, l2sqr_sift's INT distances, a
sparse space), hnsw, sw-graph and napp give tpu_knn's ids (distances
within rtol 5e-3 and atol 1e-5, ROADMAP.md's tolerance) and exactly what
the port's own synchronous call gives; dist_comps equals tpu_knn's before
any result is read. The search is gated on a threading.Event to show that
the call returns before the batch runs, that query-time parameters are
taken at dispatch, and that every other call on the index waits for the
batches in flight. Every wait that could block has a timeout of its own."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.core.errors import IndexNotBuiltError, InvalidArgumentError  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered, sparse_like  # noqa: E402
from tpu_knn_torch.methods import base as TB  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.methods import napp as TN  # noqa: E402
from tpu_knn_torch.methods import seq_search as TSS  # noqa: E402
from tpu_knn_torch.ops import graph as TG  # noqa: E402

RTOL, ATOL = 5e-3, 1e-5
CPU = {"device": "cpu"}
TIMEOUT = 60.0  # seconds any one wait may take before the test fails
RAGGED = (13, 21, 37)  # three batches in flight: buckets of 16, 32 and 64
DIM = 32

#: case -> (space, data kind, method, build params, query params)
CASES = {
    "seq_search-l2": ("l2", "dense", "seq_search", {}, None),
    "seq_search-l2-twopass": ("l2", "dense", "seq_search", {"chunkSize": 1024}, None),
    "brute_force-l2sqr_sift": ("l2sqr_sift", "uint8", "brute_force", {}, None),
    "seq_search-cosinesimil_sparse": ("cosinesimil_sparse", "sparse", "seq_search", {}, None),
    "hnsw-l2": ("l2", "dense", "hnsw", {"M": 8, "efConstruction": 40, "waveSize": 128}, {"efSearch": 20}),
    "sw-graph-l2": ("l2", "dense", "sw-graph", {"NN": 8, "waveSize": 128}, None),
    "napp-l2-scan": ("l2", "dense", "napp", {"numPivot": 64, "numPrefix": 8}, None),
    "napp-l2-gather": ("l2", "dense", "napp", {"numPivot": 64, "numPrefix": 8}, {"invProcAlg": "gather"}),
}
#: corpus rows and k of a case, where not 3000 and 10: the two-pass route
#: needs n_pad >= 8 (k + 2) 128
SIZE = {"seq_search-l2-twopass": (5000, 3)}
#: the function each method's worker runs, by module
DEVICE_FN = {"seq_search": (TSS, "_knn_device"), "hnsw": (TH, "_search_core"), "napp": (TN, "_napp_knn")}


def _data(kind: str, n: int):
    """(corpus, queries) of a data kind, made from fixed seeds."""
    if kind == "sparse":
        pts = sparse_like(n + 64, vocab=2_000, nnz=16, n_clusters=12, seed=8)
        return pts[:n], pts[n:]
    x = clustered(n + 64, DIM if kind == "dense" else 128, seed=1)
    if kind == "uint8":
        x = np.clip(np.rint(x * 40.0 + 128.0), 0, 255).astype(np.uint8)
    return x[:n], x[n:]


def _index(pkg, case: str, n: int | None = None):
    space, kind, method, build, query = CASES[case]
    n = n or SIZE.get(case, (3000, 10))[0]
    x, q = _data(kind, n)
    kw = {"data_type": {"dense": "dense_vector", "uint8": "dense_uint8_vector", "sparse": "sparse_vector"}[kind]}
    if kind == "uint8":
        kw["dist_type"] = "int"
    params = pkg.Params(dim=DIM) if space == "l2" else pkg.Params()
    idx = pkg.Index(space, params, method=method, **kw, **(CPU if pkg is tpu_knn_torch else {}))
    {"dense": idx.add_dense_batch, "uint8": idx.add_uint8_batch, "sparse": idx.add_sparse_batch}[kind](x)
    idx.build_index(pkg.Params(build))
    if query is not None:
        idx.set_query_time_params(pkg.Params(query))
    return idx, q


def _batches(q):
    """The three ragged batches, cut from the queries."""
    out, s = [], 0
    for b in RAGGED:
        out.append(q[s:s + b])
        s += b
    return out


def _within(fn, seconds: float = TIMEOUT):
    """fn() on a helper thread; its value, or its error re-raised. Fails if
    it has not returned within ``seconds``."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still blocked after {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _gate(monkeypatch, method: str, log: list | None = None):
    """Make the device function wait, on the dispatcher's worker, for the
    returned Event (set it to let the batch run); ``log`` gets "batch" when
    a gated batch is done. Synchronous calls pass straight through."""
    module, name = DEVICE_FN["hnsw" if method == "sw-graph" else method]
    real = getattr(module, name)
    gate = threading.Event()

    def gated(*args, **kw):
        if not threading.current_thread().name.startswith("tpu_knn_torch"):
            return real(*args, **kw)
        if not gate.wait(TIMEOUT):
            raise TimeoutError("the gate was never opened")
        out = real(*args, **kw)
        if log is not None:
            log.append("batch")
        return out

    monkeypatch.setattr(module, name, gated)
    return gate


@pytest.fixture(scope="module")
def pairs():
    """case -> (tpu_knn index, port index, queries), built once."""
    return {}


def _pair(pairs, case):
    if case not in pairs:
        j, q = _index(tpu_knn, case)
        t, _ = _index(tpu_knn_torch, case)
        pairs[case] = (j, t, q)
    return pairs[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_futures_match_tpu_knn(pairs, case):
    """Three ragged batches in flight at once: each future gives tpu_knn's
    future's ids (distances within tolerance) and bit for bit the port's
    synchronous result; dist_comps equals tpu_knn's at dispatch."""
    j, t, q = _pair(pairs, case)
    k = SIZE.get(case, (3000, 10))[1]
    batches = _batches(q)
    if CASES[case][1] == "sparse":
        batches = [list(b) for b in batches]
    j.method.dist_comps = 0
    t.method.dist_comps = 0
    jf = [j.knn_query_batch_async(b, k) for b in batches]
    tf = [t.knn_query_batch_async(b, k) for b in batches]
    assert t.method.dist_comps == j.method.dist_comps > 0  # read before any result
    for b, fj, ft in zip(batches, jf, tf):
        (dj, ij), (dt, it) = fj.result(), _within(ft.result)
        assert it.dtype == ij.dtype == np.int32 and dt.shape == (len(b), k)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
        ds, is_ = t.knn_query_batch(b, k)
        np.testing.assert_array_equal(dt, ds)
        np.testing.assert_array_equal(it, is_)
    if case.startswith("seq_search-l2"):
        assert t.method.last_route == ("twopass" if "twopass" in case else "single")
    assert t.method._inflight == []  # every future read


@pytest.mark.parametrize("method", ["seq_search", "hnsw", "sw-graph", "napp"])
def test_dispatch_returns_before_the_batch_runs(monkeypatch, method):
    """With the device function held on an Event, knn_query_batch_async
    returns; result() returns only once the Event is set."""
    case = next(c for c, v in CASES.items() if v[2] == method and v[1] == "dense")
    idx, q = _index(tpu_knn_torch, case, n=600)
    want = idx.knn_query_batch(q[:20], 5)
    log = []
    gate = _gate(monkeypatch, method, log)
    try:
        fut = _within(lambda: idx.knn_query_batch_async(q[:20], 5))
        time.sleep(0.2)
        assert log == []  # the batch has not run
        waiter = threading.Thread(target=fut.result, daemon=True)
        waiter.start()
        waiter.join(0.2)
        assert waiter.is_alive()  # result() waits for it
        gate.set()
        got = _within(fut.result)
    finally:
        gate.set()
    assert log == ["batch"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,before,after", [
    ("hnsw", {"efSearch": 10}, {"efSearch": 200}),
    ("sw-graph", {"efSearch": 10}, {"efSearch": 200}),
    ("napp", {"minTimes": 2, "invProcAlg": "scan"}, {"minTimes": 1, "invProcAlg": "gather"}),
])
def test_parameters_are_captured_at_dispatch(monkeypatch, method, before, after):
    """A batch dispatched at one setting gives that setting's result, though
    the method's parameters change before it runs; the Index's own
    set_query_time_params waits for the batch first."""
    case = next(c for c, v in CASES.items() if v[2] == method)
    idx, q = _index(tpu_knn_torch, case, n=600)
    idx.set_query_time_params(before)
    want = idx.knn_query_batch(q, 10)
    idx.set_query_time_params(after)
    other = idx.knn_query_batch(q, 10)
    assert not np.array_equal(want[1], other[1])  # the two settings differ here
    idx.set_query_time_params(before)
    gate = _gate(monkeypatch, method)
    try:
        fut = idx.knn_query_batch_async(q, 10)
        idx.method.set_query_time_params(tpu_knn_torch.Params(after))  # no drain at this level
        gate.set()
        got = _within(fut.result)
    finally:
        gate.set()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(idx.knn_query_batch(q, 10)[1], other[1])


def _drain_calls(tmp_path):
    """call name -> (case, call(index, queries))."""
    return {
        "knn_query_batch": ("seq_search-l2", lambda ix, q: ix.knn_query_batch(q, 3)),
        "knn_query": ("seq_search-l2", lambda ix, q: ix.knn_query(q[0], 3)),
        "range_query_batch": ("seq_search-l2", lambda ix, q: ix.range_query_batch(q, 1.0)),
        "build_index": ("seq_search-l2", lambda ix, q: ix.build_index()),
        "set_query_time_params": ("hnsw-l2", lambda ix, q: ix.set_query_time_params({"efSearch": 30})),
        "save": ("hnsw-l2", lambda ix, q: ix.save(str(tmp_path / "ix"))),
        "memory_usage_bytes": ("napp-l2-scan", lambda ix, q: ix.memory_usage_bytes()),
        "dist_comps": ("napp-l2-scan", lambda ix, q: ix.method.dist_comps),
        "graph.counters": ("hnsw-l2", lambda ix, q: dict(TG.counters)),
        "add_dense_batch": ("sw-graph-l2", lambda ix, q: ix.add_dense_batch(q[:4])),
        "delete_batch": ("sw-graph-l2", lambda ix, q: ix.delete_batch([3, 5])),
        "clear_index_cache": ("seq_search-l2", lambda ix, q: ix.clear_index_cache()),
    }


@pytest.mark.parametrize("call", sorted(_drain_calls(None)))
def test_other_calls_drain_first(monkeypatch, tmp_path, call):
    """Every other call on an index with a batch in flight returns only after
    the batch has run."""
    case, fn = _drain_calls(tmp_path)[call]
    idx, q = _index(tpu_knn_torch, case, n=600)
    want = idx.knn_query_batch(q[:8], 5)
    log = []
    gate = _gate(monkeypatch, CASES[case][2], log)
    try:
        fut = idx.knn_query_batch_async(q[:8], 5)
        opener = threading.Timer(0.3, gate.set)
        opener.start()
        _within(lambda: fn(idx, q))
        log.append("call")
        opener.join(TIMEOUT)
    finally:
        gate.set()
    assert log == ["batch", "call"]
    for a, b in zip(_within(fut.result), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["seq_search", "hnsw", "napp"])
def test_errors(monkeypatch, method):
    """k=0, a wrong width and an unbuilt method raise at the call; an error
    raised on the worker comes from result() (each time) and from the
    index's next call, which then runs again."""
    case = next(c for c, v in CASES.items() if v[2] == method and v[1] == "dense")
    idx, q = _index(tpu_knn_torch, case, n=600)
    with pytest.raises(InvalidArgumentError):
        idx.knn_query_batch_async(q[:4], 0)
    with pytest.raises(InvalidArgumentError):
        idx.knn_query_batch_async(q[:4, :8], 3)
    bare = type(idx.method)(idx.space, tpu_knn_torch.Params(CASES[case][3]))
    with pytest.raises(IndexNotBuiltError):
        bare.knn_async(q[:8], 3)
    assert bare._inflight == []
    want = idx.knn_query_batch(q[:8], 3)
    module, name = DEVICE_FN[method]
    real = getattr(module, name)

    def failing(*args, **kw):
        if threading.current_thread().name.startswith("tpu_knn_torch"):
            raise RuntimeError("injected on the worker")
        return real(*args, **kw)

    monkeypatch.setattr(module, name, failing)
    fut = idx.knn_query_batch_async(q[:8], 3)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected on the worker"):
            _within(fut.result)
    with pytest.raises(RuntimeError, match="injected on the worker"):
        _within(lambda: idx.knn_query_batch(q[:8], 3))
    got = idx.knn_query_batch(q[:8], 3)  # drained: runs again
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["seq_search-l2", "hnsw-l2", "napp-l2-scan", "napp-l2-gather"])
def test_results_do_not_depend_on_the_futures_in_flight(case):
    """The same batch alone, behind four others and ahead of four others:
    bit-identical results."""
    idx, q = _index(tpu_knn_torch, case, n=600)
    b = q[:16]
    alone = _within(idx.knn_query_batch_async(b, 10).result)
    behind = [idx.knn_query_batch_async(q[16 + 8 * i:24 + 8 * i], 10) for i in range(4)]
    behind.append(idx.knn_query_batch_async(b, 10))
    ahead = [idx.knn_query_batch_async(b, 10)]
    ahead += [idx.knn_query_batch_async(q[16 + 8 * i:24 + 8 * i], 10) for i in range(4)]
    for got in (_within(behind[-1].result), _within(ahead[0].result)):
        for a, c in zip(got, alone):
            np.testing.assert_array_equal(a, c)
    for f, g in zip(behind[:4], ahead[1:]):
        for a, c in zip(_within(f.result), _within(g.result)):
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("method", ["vptree", "simple_invindx"])
def test_other_methods_keep_materialized_futures(method):
    """vptree and simple_invindx run the batch inside the call, as in
    tpu_knn: nothing is queued, and the future gives the synchronous result."""
    if method == "vptree":
        x, q = _data("dense", 600)
        idx = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), method=method, **CPU)
        idx.add_dense_batch(x)
    else:
        x, q = _data("sparse", 600)
        idx = tpu_knn_torch.Index("negdotprod_sparse_fast", method=method, data_type="sparse_vector", **CPU)
        idx.add_sparse_batch(x)
        q = list(q)
    want = idx.knn_query_batch(q[:8], 5)
    fut = idx.knn_query_batch_async(q[:8], 5)
    assert idx.method._inflight == []
    for a, b in zip(fut.result(), want):
        np.testing.assert_array_equal(a, b)


def test_many_callers_share_the_worker():
    """Twelve caller threads (more than the cores), each with its own index,
    dispatch and read batches at once on the one CPU worker with a short
    switch interval: every result is its synchronous one and every
    dist_comps counts every batch (a lost update would break both)."""
    n_callers, n_batches = 12, 6
    x = clustered(256 + 64, 8, seed=5)
    idxs, wants = [], []
    for c in range(n_callers):
        ix = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=8), method="seq_search", **CPU)
        ix.add_dense_batch(x[:200 + c])
        wants.append([ix.knn_query_batch(x[256 + b:264 + b], 3) for b in range(n_batches)])
        ix.method.dist_comps = 0
        idxs.append(ix)
    errors = []

    def caller(c):
        try:
            ix = idxs[c]
            futs = [ix.knn_query_batch_async(x[256 + b:264 + b], 3) for b in range(n_batches)]
            for f, want in zip(futs, wants[c]):
                for a, b in zip(f.result(), want):
                    np.testing.assert_array_equal(a, b)
            assert ix.method.dist_comps == n_batches * 8 * (200 + c)
        except BaseException as e:  # noqa: BLE001 - reported by the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(c,), daemon=True) for c in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    worker = TB._workers[torch.device("cpu")]
    assert worker.thread.daemon and worker.stream is None


def test_graph_counters_count_every_search_at_once():
    """Twelve caller threads search their own small hnsw index, through
    knn_query_batch and knn_query_batch_async at once, so callers and the
    worker bump ops.graph.counters together, with a short switch interval:
    the counters end at the sum of each search's counts measured alone (a
    lost update would leave them short)."""
    n_callers, rounds = 12, 2
    x = clustered(300 + 64, 8, seed=6)
    q = x[300:308]
    idxs, solo = [], []
    for c in range(n_callers):
        ix = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=8), **CPU)
        ix.add_dense_batch(x[:200 + 5 * c])
        ix.build_index(tpu_knn_torch.Params(M=4, efConstruction=16, waveSize=64))
        TG.reset_counters()
        ix.knn_query_batch(q, 3)
        solo.append(dict(TG.counters))
        idxs.append(ix)
    errors = []

    def caller(c):
        try:
            for _ in range(rounds):
                fut = idxs[c].knn_query_batch_async(q, 3)
                idxs[c].method.knn(idxs[c]._bucket_query_points(q)[0], 3)  # beside its own batch: no drain
                fut.result()
        except BaseException as e:  # noqa: BLE001 - reported by the test's thread
            errors.append(e)

    TG.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(c,), daemon=True) for c in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert dict(TG.counters) == {key: 2 * rounds * sum(s[key] for s in solo) for key in solo[0]}
