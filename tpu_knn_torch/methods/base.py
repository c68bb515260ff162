"""Index-method abstraction (counterpart of tpu_knn/methods/base.py;
reference: include/index.h:30-113).

A Method owns encoded corpus data plus whatever acceleration structure it
builds and answers batched kNN queries. Differences from the reference,
by design:

  * Queries are *batched* host arrays; the batch dimension replaces the
    reference's per-index thread pool.
  * ``add_batch``/``delete_batch`` raise unless the method supports
    incremental maintenance (only sw-graph does in the reference,
    small_world_rand.cc:141-338).
  * ``knn_async`` of seq_search, hnsw/sw-graph and napp queues the batch
    on an in-order dispatcher (:class:`_Worker`): one daemon thread per
    torch device, with a CUDA stream of its own on the card, runs every
    index's batches one at a time in the order they were dispatched.
    A thread and not a stream alone, because these paths read back to
    the host in the middle (the graph loops' stop test, the certificate's
    block flags). Any other call on an index first drains its batches
    (:meth:`Method.drain`).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.dataset import DataStore, round_up
from ..core.errors import RuntimeNmsError, SpaceIncompatibleError
from ..core.params import Params
from ..spaces.base import Space
from ..utils import tracing

#: Distances at or above this are padding/masked sentinels, never results.
RESULT_DIST_CUTOFF = 1e29


def range_cap(max_count: int, n_pad: int) -> int:
    """Result slots per query of the collect pass: the largest count
    rounded up to 128, at most the padded corpus."""
    return min(round_up(int(max_count), 128), n_pad)


def stream_range_results(counts: np.ndarray, data, collect):
    """Shared tail of the streamed two-pass range scan: size the result cap
    from the counts pass (:func:`range_cap`), run the collect pass, and
    slice per-query (ids, dists).
    ``collect(cap)`` returns ([Q, cap] dists, [Q, cap] corpus positions)
    ascending with (+inf, -1) pads. Ids come back in ``data.ids``' int32,
    dists in f32; a query without hits gets two empty arrays."""
    f32 = np.zeros(0, np.float32)
    if counts.max(initial=0) == 0:
        return [(np.zeros(0, np.int32), f32) for _ in range(counts.shape[0])]
    dk, pos = collect(range_cap(counts.max(), data.ids.shape[0]))
    with tracing.sync("range_results"):
        dk, pos, ids = dk.cpu().numpy(), pos.cpu().numpy(), data.ids.cpu().numpy()
    return [(ids[pos[i, :c]].copy(), dk[i, :c].copy()) for i, c in enumerate(counts)]


def _record_stream(obj, stream) -> None:
    """Tell the caching allocator that the card tensors in ``obj`` (a
    tensor, or dicts, lists and tuples of them) are used on ``stream``,
    so their memory is not handed out again before its work is done."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            obj.record_stream(stream)
    elif isinstance(obj, dict):
        for v in obj.values():
            _record_stream(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _record_stream(v, stream)


def _to_host(v):
    """A card tensor copied without blocking into pinned host memory; any
    other value as it is."""
    if isinstance(v, torch.Tensor) and v.device.type == "cuda":
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        return h
    return v


class _Job:
    """One dispatched batch. ``fn`` runs on the worker and returns a tuple
    whose tensors come back to the host (pinned, behind ``event`` on the
    card); ``ready`` is the caller's stream at dispatch; ``batch`` the
    caller's trace batch id (utils/tracing.py)."""

    __slots__ = ("fn", "ready", "batch", "done", "host", "error", "event")

    def __init__(self, fn, ready):
        self.fn = fn
        self.ready = ready
        self.batch = tracing.current_batch()
        self.done = threading.Event()
        self.host = None
        self.error: Exception | None = None
        self.event = None

    def wait(self) -> tuple:
        """Block until the batch has run and its copies have landed;
        re-raise the error it raised. The batch's spans read their device
        time here, once its results are on the host."""
        tracing.SYNCS.bump("job")
        with tracing.span("api.wait"):
            self.done.wait()
            if self.error is not None:
                raise self.error
            if self.event is not None:
                self.event.synchronize()
            tracing.resolve(self.batch)
        return self.host


class _Worker:
    """The process-wide FIFO worker of one torch device: a daemon thread
    started on first use and, on the card, a stream of its own. Jobs run
    one at a time in the order they were submitted, whichever index
    submitted them; a job's exception is kept for its future and the
    index's next drain, never logged and dropped."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.jobs: queue.SimpleQueue = queue.SimpleQueue()
        self.last: _Job | None = None
        self.thread = threading.Thread(target=self._loop, name=f"tpu_knn_torch {device}", daemon=True)
        self.thread.start()

    def submit(self, fn, crossing) -> _Job:
        ready = None
        if self.stream is not None:
            # the worker's stream first waits for what the caller has queued
            # (a build or an add just enqueued); the caller-made tensors the
            # job reads are marked as used on the worker's stream
            ready = torch.cuda.current_stream(self.device).record_event()
            _record_stream(crossing, self.stream)
        job = _Job(fn, ready)
        self.last = job
        self.jobs.put(job)
        return job

    def _loop(self) -> None:
        if self.stream is not None:
            torch.cuda.set_device(self.device)
        while True:
            job = self.jobs.get()
            try:
                if self.stream is None:
                    with tracing.batch("dispatcher.run", job.batch):
                        job.host = tuple(job.fn())
                else:
                    with torch.cuda.stream(self.stream):
                        with tracing.batch("dispatcher.run", job.batch):
                            self.stream.wait_event(job.ready)
                            job.host = tuple(_to_host(v) for v in job.fn())
                        job.event = self.stream.record_event()
            except Exception as e:  # noqa: BLE001 - re-raised by the future and the drain
                job.error = e
            finally:
                job.fn = None
                job.done.set()


_workers: dict[torch.device, _Worker] = {}
_workers_lock = threading.Lock()


def _worker(device: torch.device) -> _Worker:
    with _workers_lock:
        w = _workers.get(device)
        if w is None:
            w = _workers[device] = _Worker(device)
        return w


def drain_all() -> None:
    """Wait until every worker has run every batch submitted to it so far
    (ops.graph.counters reads call this)."""
    for w in list(_workers.values()):
        if w.last is not None:
            w.last.done.wait()


class Method:
    name: str = "abstract"
    supports_range: bool = True
    supports_incremental: bool = False

    def __init__(self, space: Space, params: Params | None = None):
        self.space = space
        self.index_params = Params.of(params)
        self.query_params = Params()
        self.data = None  # encoded corpus
        self.store: DataStore | None = None
        self._dc_base = 0
        self._dc_pending: list = []
        self._inflight: list[_Job] = []  # dispatched batches not yet drained

    # -- distance-computation counter (reference: query.h:33) --
    # Converting a device scalar eagerly would force a blocking
    # device-to-host sync on EVERY query call; counts are appended as
    # device scalars (or host ints) and only summed when the counter is
    # read, after the batches in flight.
    @property
    def dist_comps(self) -> int:
        self.drain()
        if self._dc_pending:
            self._dc_base += sum(
                int(x.sum().item()) if isinstance(x, torch.Tensor) else int(np.asarray(x, np.int64).sum())
                for x in self._dc_pending
            )
            self._dc_pending.clear()
        return self._dc_base

    @dist_comps.setter
    def dist_comps(self, v) -> None:
        self.drain()
        self._dc_base = int(v)
        self._dc_pending.clear()

    def _add_dist_comps(self, nd) -> None:
        self._dc_pending.append(nd)

    # -- lifecycle --
    def create_index(self, store: DataStore, params: Params | None = None) -> None:
        raise NotImplementedError

    def set_query_time_params(self, params: Params | None) -> None:
        self.query_params = Params.of(params)

    # -- queries --
    def knn(self, points: Any, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN. Returns (dists[B,k], ids[B,k]) sorted ascending;
        missing results (k > corpus) have id -1 and dist +inf."""
        raise NotImplementedError

    def range(self, points: Any, radius: float) -> list[tuple[np.ndarray, np.ndarray]]:
        raise SpaceIncompatibleError(f"Range search is not supported by {self.name}!")

    def knn_async(self, points: Any, k: int):
        """Dispatch a kNN batch; return a zero-arg callable that gives
        (dists, ids), as ``knn`` does.

        seq_search/brute_force, hnsw/sw-graph and napp validate, encode
        the queries and capture every query-time parameter here, in the
        caller's thread, then queue the search on the device's worker
        (:meth:`_dispatch`) and return at once; the callable waits for
        it. The default, kept by the other methods as in tpu_knn, runs
        ``knn`` now and returns its result already materialized."""
        d, i = self.knn(points, k)
        return lambda: (d, i)

    # -- the in-order dispatcher --
    def _dispatch(self, run: Callable[[], tuple], finish: Callable, crossing):
        """Queue ``run`` on the worker of the index's device and return the
        finisher of :meth:`knn_async`: it waits for the batch, re-raising
        its error, and gives ``finish(*arrays)``, ``run()``'s tensors as
        numpy arrays. ``crossing`` holds the caller-made tensors ``run``
        reads (the encoded queries)."""
        job = _worker(self.data.ids.device).submit(run, crossing)
        self._inflight.append(job)

        def result():
            host = job.wait()
            if job in self._inflight:  # read: no longer the drain's business
                self._inflight.remove(job)
            return finish(*(v.numpy() for v in host))

        return result

    def drain(self) -> None:
        """Wait for every batch this index has in flight, then re-raise
        the first error among them (also when its future raised it
        already). A no-op check with none in flight."""
        if not self._inflight:
            return
        jobs, self._inflight = self._inflight, []
        first = None
        for job in jobs:
            try:
                job.wait()
            except Exception as e:  # noqa: BLE001 - every job is waited for, the first error raised
                first = first or e
        if first is not None:
            raise first

    # -- persistence (reference: index.h:56-63) --
    def save(self, path: str) -> None:
        raise RuntimeNmsError(f"save not supported by {self.name}")

    def load(self, path: str, store: DataStore) -> None:
        raise RuntimeNmsError(f"load not supported by {self.name}")

    # -- persistence state hooks (used by io/persist.py) --
    def state_arrays(self) -> dict:
        """Method-specific index state as host arrays. Default: nothing,
        restore() rebuilds."""
        return {}

    def restore(self, store: DataStore, state: dict, params: Params | None = None) -> None:
        """Reconstruct from saved state; default rebuilds from the data."""
        self.create_index(store, params)

    def aux_device_arrays(self):
        """Tensors beyond .data that count toward the index footprint
        (memory_usage_bytes). Default: none."""
        return ()

    # -- incremental maintenance --
    def add_batch(self, store: DataStore, new_positions: Sequence[int]) -> None:
        raise RuntimeNmsError(f"{self.name} does not support incremental addition")

    def delete_batch(self, positions: Sequence[int], strategy: str = "none") -> None:
        raise RuntimeNmsError(f"{self.name} does not support deletion")

    # -- helpers --
    def _finalize_knn(self, dists, ids) -> tuple[np.ndarray, np.ndarray]:
        """Convert results to host numpy, mapping masked sentinels to
        (+inf, -1)."""
        d = np.asarray(dists)
        i = np.asarray(ids)
        bad = d >= RESULT_DIST_CUTOFF
        d = np.where(bad, np.inf, d)
        i = np.where(bad, -1, i)
        return d, i
