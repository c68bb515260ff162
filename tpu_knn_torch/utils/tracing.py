"""Spans and counters of the package, on the profiler's clock.

Spans
-----
``with span(name):`` marks a stretch of host code where the work happens:
a layer boundary of the query path, a stage of the exact scan, a phase of
the HNSW build. A span records only while the tracer is on: while a
``torch.profiler`` session runs, or after :func:`enable`. Off, ``span``
returns one shared no-op object after a flag check, and calls neither CUDA
nor the profiler.

On, a span

* opens a profiler range ``tpu_knn_torch.<name>``. It is not a user
  annotation, so it lands among the profiler's host events on their clock:
  a chrome trace (``export_chrome_trace``) shows the spans beside the
  kernels they launched, and a reduction of the trace can put down an idle
  stretch of the card to the innermost span running then;
* keeps a record (:class:`Record`): name, start and end in ns on the
  profiler's clock (``time.time_ns``), parent span, thread, and batch id.
  Every span of one query batch, on the caller's thread and on the
  dispatcher's worker (methods/base.py), shares the id that the API's
  entry gives it (:func:`batch`);
* if it is ``timed`` and CUDA is started, records a pair of timing
  events on the current stream. Only the spans whose device time a reader
  uses are timed (``seq_search.pass2``, ``seq_search.merge`` and the HNSW
  build's ``hnsw.wave.*``): under the profiler, events on every span of
  the sparse scan left the card idle several points more of the time.
  Their elapsed ms is read (:func:`resolve`) where the program already
  waits for the batch's results, so tracing adds no synchronisation to the
  query path; what no batch waited for is read at :func:`totals` or
  :func:`spans`. Once read, the events go back to a pool for the next
  spans.

A loop of hundreds of iterations a batch (the chunk loop of ops/topk.py)
traces one iteration in :data:`EVERY` (:func:`sampled`), and that span
stands for the iterations up to the next traced one. On the card a span
costs a few microseconds of host time and a few CUDA calls, and each
timing event leaves a gap between kernels; the sparse scan issues 2,500
launches a batch at the card's pace from a worker thread that shares the
interpreter lock with the caller, and under the profiler a span on every
iteration left the card idle several points more of the time.

:func:`totals` sums the records by name: calls, host ms, host self ms (a
span's duration less its child spans') and device ms. :func:`spans` gives
the records, :func:`reset` clears them. There is no exporter of its own:
the profiler's trace is the export.

Counters
--------
Host ints in named groups (:func:`counters`), always on, bumped under one
lock (the dispatcher's worker and callers count at once). A read of a
group first waits for the batches in flight on the dispatcher's workers,
so it counts every batch dispatched before it. The groups: ``graph``
(ops/graph.py's loops), ``launches`` (ops/groupmin.py's kernel launches by
tier and form), ``kernels`` (``builds``: nvcc builds; ``loads``: libraries
loaded) and ``sync`` (one count for each device-to-host wait of the query
path, by site: :func:`sync`).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tpu_knn_torch."
#: a loop of many small stages a batch traces one iteration in this many
EVERY = 64

_lock = threading.Lock()
_enabled = False
#: closed spans, in the order they closed
_records: list = []
#: batch id -> closed spans whose device time is unread (None: no batch)
_pending: dict = {}
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)
#: device index -> free (start, end) pairs of timing events
_free_events: dict = {}


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []
        self.batch = None


_thread = _Thread()


class _Off:
    """What :func:`span` gives while the tracer is off."""

    __slots__ = ()
    batch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def enable() -> None:
    """Record spans until :func:`disable`, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler runs (the default)."""
    global _enabled
    _enabled = False


def _event_pair(device_index: int) -> tuple:
    """A free (start, end) pair of timing events of the device, or a new one."""
    with _lock:
        free = _free_events.get(device_index)
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class Record(NamedTuple):
    """A closed span. ``parent``: the id of the innermost span open on the
    same thread when it opened (or None); ``batch``: the query batch it
    served (or None); ``start_ns``/``end_ns``: the profiler's clock;
    ``child_ns``: what its child spans cover; ``device_ms``: the elapsed time
    of its pair of CUDA events, None off the card and for an untimed span;
    ``weight``: the like stretches it stands for (:func:`sampled`)."""

    name: str
    id: int
    parent: int | None
    thread: int
    batch: object
    start_ns: int
    end_ns: int
    child_ns: int
    weight: int
    device_ms: float | None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        """Duration less what the span's children cover."""
        return self.end_ns - self.start_ns - self.child_ns


class Span:
    """One traced stretch of host code while it is open. Closed, it leaves a
    plain tuple in the store (a :class:`Record`'s fields: the cyclic garbage
    collector then need not walk the hundreds of thousands a traced run
    keeps), and while its device time is unread, itself in ``_pending``."""

    __slots__ = ("name", "id", "parent", "batch", "start_ns", "child_ns", "_root", "_weight", "_timed",
                 "_outer", "_events", "_stream", "_range", "_index")

    def __init__(self, name: str, batch, root: bool = False, weight: int = 1, timed: bool = False):
        self.name, self.batch, self._root, self._weight, self._timed = name, batch, root, weight, timed
        self.child_ns = 0

    def __enter__(self):
        # the clock read next to the profiler range's edges, and the event
        # records (which wait while the launch queue is full) inside them
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        stack = _thread.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self)
        if self._root:
            self._outer, _thread.batch = _thread.batch, self.batch
        self._events = None
        if self._timed and torch.cuda.is_initialized():
            stream = self._stream = torch.cuda.current_stream()
            self._events = _event_pair(stream.device_index)
            self._events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        end_ns = time.time_ns()
        self._range.__exit__(None, None, None)
        self._range = None
        _thread.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += end_ns - self.start_ns
        if self._root:
            _thread.batch = self._outer
        record = (self.name, self.id, parent and parent.id, threading.get_ident(), self.batch, self.start_ns,
                  end_ns, self.child_ns, self._weight, None)
        self.parent = None
        with _lock:
            self._index = len(_records)
            _records.append(record)
            if self._events is not None:
                _pending.setdefault(self.batch, []).append(self)
        return False


def span(name: str, weight: int = 1, timed: bool = False):
    """A span of ``name`` in the thread's current batch (a context manager),
    counted ``weight`` times by :func:`totals`; none with ``weight`` 0; with
    ``timed`` its device time too."""
    if not (weight and (_enabled or _profiler._is_profiler_enabled)):
        return OFF
    return Span(name, _thread.batch, weight=weight, timed=timed)


def sampled(i: int, n: int) -> int:
    """The span weight of iteration ``i`` of a loop of ``n`` that traces one
    in :data:`EVERY`: the iterations it stands for, 0 for the others."""
    return 0 if i % EVERY else min(EVERY, n - i)


def batch(name: str, batch_id=None):
    """A span of ``name`` that serves one query batch: spans opened inside it
    on this thread carry ``batch_id``, a new id when None. Its ``batch``
    attribute gives the id to carry to another thread (None while off)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return OFF
    return Span(name, next(_batch_ids) if batch_id is None else batch_id, root=True)


def current_batch():
    """The batch id of the innermost :func:`batch` span open on this thread."""
    return _thread.batch


def _read_device(s: Span) -> bool:
    """Write a closed span's device ms into its record, once its end event has
    completed, and free its events."""
    start, end = s._events
    if not end.query():  # not completed yet
        return False
    ms = start.elapsed_time(end)
    s._events = None
    _free_events.setdefault(s._stream.device_index, []).append((start, end))
    with _lock:
        i = s._index
        if i < len(_records) and _records[i][1] == s.id:  # not dropped by a reset
            _records[i] = _records[i][:-1] + (ms,)
    return True


def resolve(batch_id) -> None:
    """Read the device ms of ``batch_id``'s spans, and of the spans of no
    batch, whose events have completed; those not yet completed wait for the
    next call. Called once the batch's results are on the host: it waits
    for nothing."""
    if not _pending:
        return
    with _lock:
        todo = _pending.pop(batch_id, []) + (_pending.pop(None, []) if batch_id is not None else [])
    late = [s for s in todo if not _read_device(s)]
    if late:
        with _lock:
            _pending.setdefault(None, []).extend(late)


def _settle() -> list:
    """Every record as a tuple, with the device time of each read: waits
    for the dispatcher's batches and the spans' events."""
    from ..methods.base import drain_all  # methods import this module

    drain_all()
    with _lock:
        todo = [s for v in _pending.values() for s in v]
        _pending.clear()
    for s in todo:
        for e in s._events:
            e.synchronize()
        _read_device(s)
    with _lock:
        return list(_records)


def spans() -> list:
    """The records (:class:`Record`), in the order the spans closed."""
    return [Record(*r) for r in _settle()]


def totals() -> dict:
    """Span name -> {"calls", "host_ms", "self_ms", "device_ms"} over the
    records, each counted its weight times (a sampled loop's traced
    iterations for the rest). ``device_ms`` is None where no span of the
    name has a device time (off the card)."""
    out: dict = {}
    for name, _, _, _, _, start, end, child, w, device in _settle():
        t = out.get(name)
        if t is None:
            t = out[name] = {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None}
        t["calls"] += w
        t["host_ms"] += (end - start) * w * 1e-6
        t["self_ms"] += (end - start - child) * w * 1e-6
        if device is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + device * w
    return out


def reset() -> None:
    """Drop every record."""
    with _lock:
        _records.clear()
        _pending.clear()


class Counters(dict):
    """One group of host counts: a dict whose reads first wait for the
    batches in flight on the dispatcher's workers (methods/base.drain_all),
    and whose counts are bumped under the package's one lock."""

    def bump(self, key: str) -> None:
        with _lock:
            dict.__setitem__(self, key, dict.get(self, key, 0) + 1)

    def reset(self) -> None:
        with _lock:
            for key in dict.keys(self):
                dict.__setitem__(self, key, 0)

    @staticmethod
    def _drain() -> None:
        from ..methods.base import drain_all  # methods import this module

        drain_all()

    def __getitem__(self, key):
        self._drain()
        return dict.__getitem__(self, key)

    def __iter__(self):
        self._drain()
        return dict.__iter__(self)

    def __repr__(self):
        self._drain()
        return dict.__repr__(self)

    def get(self, key, default=None):
        self._drain()
        return dict.get(self, key, default)

    def keys(self):
        self._drain()
        return dict.keys(self)

    def values(self):
        self._drain()
        return dict.values(self)

    def items(self):
        self._drain()
        return dict.items(self)

    def copy(self):
        self._drain()
        return dict(dict.items(self))


_groups: dict = {}


def counters(group: str, *keys: str) -> Counters:
    """The counter group ``group``, made on first use with ``keys`` at 0 (a
    key bumped later starts at 0 too)."""
    with _lock:
        c = _groups.get(group)
        if c is None:
            c = _groups[group] = Counters(dict.fromkeys(keys, 0))
        return c


def counts() -> dict:
    """Every counter as ``{"<group>.<key>": n}``."""
    return {f"{g}.{k}": n for g, c in list(_groups.items()) for k, n in c.items()}


#: device-to-host waits of the query path, by site
SYNCS = counters("sync")


def sync(site: str):
    """A device-to-host wait at ``site`` of the query path: counted in the
    ``sync`` group always, a span ``sync.<site>`` while on."""
    SYNCS.bump(site)
    return span("sync." + site)
