"""The port's tracer (tpu_knn_torch/utils/tracing.py) on the CPU: spans off
and on, their place among torch.profiler's host events, self times, the
batch id shared by a batch's caller and worker spans, the spans each path
of the exact scan emits, the counter groups, and the benchmark's five
readers of the spans (knnbench/metrics/)."""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered, sparse_like  # noqa: E402
from tpu_knn_torch.methods import hnsw as TH  # noqa: E402
from tpu_knn_torch.ops import graph as TG  # noqa: E402
from tpu_knn_torch.ops import groupmin as GM  # noqa: E402
from tpu_knn_torch.utils import tracing  # noqa: E402

DIM = 16
#: the two-pass route needs n_pad >= 8 (k + 2) 128 rows
N_TWOPASS, K = 5000, 3
READERS = ("api_host_ms", "issue_host_ms", "encode_host_ms", "pass2_device_ms", "merge_device_ms")


@pytest.fixture
def traced():
    """The tracer on, its store empty before and after."""
    tracing.reset()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


def _dense_index(n=N_TWOPASS, chunk=1024):
    x = clustered(n + 64, DIM, seed=3)
    params = {"chunkSize": chunk} if chunk else {}
    ix = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), method="seq_search", device="cpu")
    ix.add_dense_batch(x[:n])
    ix.build_index(tpu_knn_torch.Params(params))
    return ix, x[n:]


def _sparse_index(n=600):
    xs = sparse_like(n + 32, vocab=256, nnz=12, n_clusters=8, seed=5)
    ix = tpu_knn_torch.Index("negdotprod_sparse", method="seq_search", data_type="sparse_vector", device="cpu")
    ix.add_sparse_batch(xs[:n])
    ix.build_index(tpu_knn_torch.Params(chunkSize=128))
    return ix, xs[n:]


def _names():
    return {s.name for s in tracing.spans()}


def test_off_records_nothing_and_calls_neither_cuda_nor_the_profiler(monkeypatch):
    """Off, every span is the one shared no-op object; no CUDA event and no
    profiler range is made along the query path, and nothing is recorded.
    The sync counters still count."""
    tracing.disable()
    tracing.reset()
    ix, q = _dense_index(n=400)

    def boom(*a, **k):
        raise AssertionError("called while the tracer is off")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert tracing.span("a") is tracing.span("b") is tracing.batch("c") is tracing.OFF
    before = tracing.SYNCS.get("range_counts", 0)
    ix.knn_query_batch_async(q[:8], K).result()
    ix.knn_query_batch(q[:8], K)
    ix.range_query_batch(q[:8], 1.0)
    assert tracing.spans() == [] and tracing.totals() == {}
    assert tracing.SYNCS["range_counts"] == before + 1


def test_spans_are_profiler_host_events_on_its_clock():
    """Under torch.profiler each span is a host event that is no user
    annotation, named ``tpu_knn_torch.<name>``, whose start and end lie within
    0.1 ms of the record's; the benchmark's trace reduction keeps them as
    host operations of its window. (The profiler sees the dispatcher
    worker's spans when it profiles all threads; the tracer records them
    either way.)"""
    from knnbench.trace import WINDOW, reduce_events

    tracing.reset()
    ix, q = _dense_index()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        assert isinstance(tracing.span("x"), tracing.Span)
        with torch.profiler.record_function(WINDOW):
            ix.knn_query_batch_async(q[:8], K).result()
            ix.range_query_batch(q[:8], 1.0)
    finally:
        prof.stop()
    assert tracing.span("x") is tracing.OFF
    records = tracing.spans()
    tracing.reset()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith(tracing.PREFIX)]
    assert records and len(events) == len(records)
    by_name: dict = {}
    for e in events:
        assert not e.is_user_annotation()
        by_name.setdefault(e.name(), []).append(e)
    for name, evs in by_name.items():
        recs = sorted((s for s in records if tracing.PREFIX + s.name == name), key=lambda s: s.start_ns)
        evs.sort(key=lambda e: e.start_ns())
        assert len(recs) == len(evs)
        for s, e in zip(recs, evs):
            assert abs(e.start_ns() - s.start_ns) < 100_000 and abs(e.end_ns() - s.end_ns) < 100_000
    host = {n for n, _, _ in reduce_events(prof.profiler.kineto_results.events()).host}
    assert {tracing.PREFIX + s.name for s in records} <= host


def test_self_time_is_duration_less_direct_children(traced):
    with tracing.span("outer"):
        time.sleep(0.002)
        with tracing.span("child"):
            time.sleep(0.003)
            with tracing.span("grandchild"):
                time.sleep(0.002)
        with tracing.span("child"):
            time.sleep(0.001)
    recs = {}
    for s in tracing.spans():
        recs.setdefault(s.name, []).append(s)
    (outer,), (grand,) = recs["outer"], recs["grandchild"]
    c1, c2 = recs["child"]
    assert grand.parent == c1.id and c1.parent == outer.id == c2.parent and outer.parent is None
    assert outer.self_ns == outer.host_ns - c1.host_ns - c2.host_ns
    assert c1.self_ns == c1.host_ns - grand.host_ns and grand.self_ns == grand.host_ns
    assert outer.self_ns >= 2_000_000 and c1.self_ns >= 3_000_000
    t = tracing.totals()
    assert t["child"]["calls"] == 2
    assert t["child"]["host_ms"] == pytest.approx((c1.host_ns + c2.host_ns) * 1e-6)
    assert t["child"]["self_ms"] == pytest.approx((c1.self_ns + c2.self_ns) * 1e-6)
    assert t["outer"]["self_ms"] == pytest.approx(outer.self_ns * 1e-6)


def test_closed_spans_leave_plain_tuples(traced):
    """A closed span leaves a tuple of plain values in the store, which the
    cyclic garbage collector stops tracking: a traced run keeps hundreds of
    thousands, and full collections would otherwise walk them all."""
    import gc

    with tracing.batch("outer"):
        with tracing.span("inner"):
            pass
    gc.collect()
    assert len(tracing._records) == 2
    assert all(type(r) is tuple and not gc.is_tracked(r) for r in tracing._records)


def test_a_sampled_loop_counts_each_traced_iteration_for_those_it_stands_for(traced):
    """A loop that traces one iteration in EVERY gives the traced one the
    weight of the iterations up to the next; totals counts it that often."""
    n = 2 * tracing.EVERY + 3
    weights = [tracing.sampled(i, n) for i in range(n)]
    assert weights == [tracing.EVERY if i in (0, tracing.EVERY) else 3 if i == 2 * tracing.EVERY else 0
                       for i in range(n)]
    for w in weights:
        with tracing.span("stage", w):
            time.sleep(0.0005)
    recs = tracing.spans()
    assert [r.weight for r in recs] == [w for w in weights if w]
    t = tracing.totals()["stage"]
    assert t["calls"] == n
    assert t["host_ms"] == pytest.approx(sum(r.host_ns * r.weight for r in recs) * 1e-6)
    tracing._records[:] = [r[:-1] + (2.0,) for r in tracing._records]
    assert tracing.totals()["stage"]["device_ms"] == pytest.approx(2.0 * n)


def test_async_batch_shares_one_id_across_caller_and_worker(traced):
    """Every span of an async kNN batch, on the caller's thread (dispatch,
    encode, result, wait) and on the dispatcher's worker (its run and the
    scan's stages), carries the batch id given at the API's entry; the next
    batch gets another."""
    ix, q = _dense_index()
    tracing.reset()
    futs = [ix.knn_query_batch_async(q[:8], K), ix.knn_query_batch_async(q[8:16], K)]
    for f in futs:
        f.result()
    batches: dict = {}
    for s in tracing.spans():
        batches.setdefault(s.batch, []).append(s)
    assert None not in batches and len(batches) == 2
    for spans in batches.values():
        names = {s.name for s in spans}
        assert {"api.knn_async", "spaces.encode", "dispatcher.run", "seq_search.pass1", "seq_search.pass2",
                "api.result", "api.wait"} <= names
        threads = {s.name: s.thread for s in spans}
        assert threads["api.knn_async"] == threads["api.result"] == threading.get_ident()
        assert threads["dispatcher.run"] == threads["seq_search.pass2"] != threading.get_ident()


#: path -> (index maker, the call, spans it emits, sync sites it counts)
PATHS = {
    "twopass": (lambda: _dense_index(), lambda ix, q: ix.knn_query_batch_async(q[:8], K).result(),
                {"api.knn_async", "api.result", "api.wait", "dispatcher.run", "spaces.encode",
                 "seq_search.pass1", "seq_search.select", "seq_search.pass2"}, {"job"}),
    "twopass_sync": (lambda: _dense_index(), lambda ix, q: ix.knn_query_batch(q[:8], K),
                     {"api.knn", "spaces.encode", "seq_search.pass1", "seq_search.select", "seq_search.pass2",
                      "sync.knn_result"}, {"knn_result"}),
    "sparse_single_pass": (lambda: _sparse_index(), lambda ix, q: ix.knn_query_batch_async(q[:8], K).result(),
                           {"api.knn_async", "api.result", "api.wait", "dispatcher.run", "spaces.encode",
                            "spaces.densify", "seq_search.chunk", "seq_search.merge"}, {"job"}),
    "range": (lambda: _dense_index(n=1200, chunk=256), lambda ix, q: ix.range_query_batch(q[:8], 2.0),
              {"api.range", "spaces.encode", "seq_search.range_count", "sync.range_counts",
               "seq_search.range_collect", "seq_search.chunk", "seq_search.merge", "sync.range_results"},
              {"range_counts", "range_results"}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_emits_its_spans(traced, path):
    make, call, want, sites = PATHS[path]
    ix, q = make()
    assert {"index.add", "index.build", "spaces.encode_dataset", "spaces.pack"} <= _names()
    tracing.reset()
    before = {site: tracing.SYNCS.get(site, 0) for site in sites}
    call(ix, q)
    names = _names()
    assert names == want, (names - want, want - names)
    assert all(tracing.SYNCS[site] == before[site] + 1 for site in sites)
    assert not any(n.startswith("hnsw.") for n in names)


class _FakeEvent:
    def record(self, stream):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 1.0


class _FakeStream:
    device_index = 0


def test_only_the_spans_a_reader_times_record_events(traced, monkeypatch):
    """With CUDA started, the spans whose device time a reader uses (pass 2
    and the merges) record timing events, and no other span of the paths
    does: events on every span cost the card idle time under the profiler."""
    made = []

    def pair(device_index):
        made.append(device_index)
        return _FakeEvent(), _FakeEvent()

    monkeypatch.setattr(tracing, "_event_pair", pair)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    for path in ("twopass", "sparse_single_pass", "range"):
        make, call, want, _ = PATHS[path]
        ix, q = make()
        tracing.reset()
        made.clear()
        call(ix, q)
        timed = {s.name for s in tracing.spans() if s.device_ms is not None}
        assert timed == want & {"seq_search.pass2", "seq_search.merge"}, (path, timed)
        assert len(made) == sum(1 for s in tracing.spans() if s.device_ms is not None)


def test_device_ms_is_none_off_the_card(traced):
    ix, q = _dense_index()
    ix.knn_query_batch_async(q[:8], K).result()
    assert all(s.device_ms is None for s in tracing.spans())
    assert all(t["device_ms"] is None for t in tracing.totals().values())


def test_hnsw_wave_phases_are_spans(traced):
    """The build's wave step traces its phases as hnsw.wave.* spans; the old
    phase timer and its hooks are gone."""
    import inspect

    assert "profile" not in inspect.signature(TH.make_wave_step).parameters
    assert not hasattr(TH.Hnsw, "wave_profile") and not hasattr(TH, "_Span")
    x = clustered(400, DIM, seed=4)
    ix = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), device="cpu")
    ix.add_dense_batch(x)
    ix.build_index(tpu_knn_torch.Params(M=4, efConstruction=16, waveSize=64))
    names = _names()
    assert {"hnsw.wave.beam", "hnsw.wave.mates", "hnsw.wave.forward", "hnsw.wave.reverse"} <= names
    assert tracing.totals()["hnsw.wave.beam"]["calls"] >= 400 // 64


def test_counter_groups_read_as_before():
    """ops.graph.counters and GM.launches are groups of the one store: the
    same keys as before, reset by their own functions, read through
    tracing.counts() too."""
    assert isinstance(TG.counters, tracing.Counters) and isinstance(GM.launches, tracing.Counters)
    assert set(TG.counters) == {"beam_iters", "beam_syncs", "descent_steps", "descent_syncs"}
    assert set(GM.launches) == set(GM.TIERS) | set(GM.ELEMENTWISE) | set(GM.SPARSE_QDENSE)
    x = clustered(364, DIM, seed=6)
    ix = tpu_knn_torch.Index("l2", tpu_knn_torch.Params(dim=DIM), device="cpu")
    ix.add_dense_batch(x[:300])
    ix.build_index(tpu_knn_torch.Params(M=4, efConstruction=16, waveSize=64))
    TG.reset_counters()
    assert dict(TG.counters) == dict.fromkeys(TG.counters, 0)
    ix.knn_query_batch_async(x[300:308], 3).result()
    c = dict(TG.counters)
    assert c["beam_iters"] >= 1 and c["beam_syncs"] >= 1
    flat = tracing.counts()
    assert all(flat[f"graph.{k}"] == v for k, v in c.items())
    assert {"kernels.builds", "kernels.loads"} <= set(flat)


def _run(n_batches):
    from knnbench.harness import Run

    return Run(cell=None, inputs=None, device=torch.device("cpu"), latencies=[0.01] * n_batches)


def _reader(name):
    from knnbench.registry import find

    return find("metrics", name).read


@pytest.mark.parametrize("name", READERS)
def test_metric_readers(traced, monkeypatch, name):
    """Each reader gives its value a batch from the spans of a CPU run of the
    paths its cells take (the device readers from device times set on the
    records, as the card's events would), and None without spans or without
    the tracer."""
    read = _reader(name)
    (ix, q), (sx, sq), (rx, rq) = _dense_index(), _sparse_index(), _dense_index(n=1200, chunk=256)
    tracing.reset()
    assert read(_run(3)) is None
    ix.knn_query_batch_async(q[:8], K).result()
    sx.knn_query_batch_async(sq[:8], K).result()
    rx.range_query_batch(rq[:8], 2.0)
    tracing.spans()
    if name.endswith("_device_ms"):
        assert read(_run(3)) is None  # no device time off the card
        tracing._records[:] = [r[:-1] + (1.0,) for r in tracing._records]
    got = read(_run(3))
    t = tracing.totals()
    want = {
        "api_host_ms": sum(t[n]["self_ms"] for n in ("api.knn_async", "api.result", "api.range")) / 3,
        "issue_host_ms": (t["dispatcher.run"]["host_ms"] + t["seq_search.range_count"]["host_ms"]
                          + t["seq_search.range_collect"]["host_ms"] - t["sync.range_counts"]["host_ms"]) / 3,
        "encode_host_ms": t["spaces.encode"]["self_ms"] / 3,
        "pass2_device_ms": t["seq_search.pass2"]["calls"] / 3,
        "merge_device_ms": t["seq_search.merge"]["calls"] / 3,
    }[name]
    assert got == pytest.approx(want, rel=1e-9) and got > 0
    monkeypatch.setitem(sys.modules, "tpu_knn_torch.utils.tracing", None)  # as on a program without it
    monkeypatch.delattr(tpu_knn_torch.utils, "tracing")
    assert read(_run(3)) is None


def test_counters_count_every_bump_under_contention():
    """Threads bump one counter group at once, with a short switch interval:
    no update is lost."""
    group = tracing.Counters(n=0)
    n_threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [group.bump("n") for _ in range(per)], daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert group["n"] == n_threads * per
