"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the per-layer metrics read.

The window is a ``record_function`` range around the timed loop; every
device operation (kernel, copy, fill) that lies in it is kept with its
name, start and end, and every host operation (torch op, CUDA runtime
call) with its thread, so that an idle stretch of the device can be put
down to what the host was doing then.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

WINDOW = "knnbench.window"
#: breakdown entries kept per list
TOP = 10
#: longest name kept in the breakdown
NAME_CHARS = 160


@dataclass
class Trace:
    """Times in seconds from the window's start."""

    window_s: float
    #: (name, start, end) of each device operation, by start
    device: list = field(default_factory=list)
    #: (name, start, end) of each host operation, by start
    host: list = field(default_factory=list)

    def kernels(self) -> list:
        """Device operations that are kernel launches (not copies or fills)."""
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def busy(self) -> float:
        """Seconds in which some device operation ran, within the window."""
        return sum(e - s for s, e in self.busy_spans())

    def busy_spans(self) -> list:
        spans = []
        for _, s, e in self.device:
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        return spans

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no device operation."""
        gaps, t = [], 0.0
        for s, e in self.busy_spans():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def hosts_at(self, times: list) -> list:
        """For each of the ascending ``times``, the innermost host operation
        running then (the latest started of any thread), or "python" when
        none was."""
        out, heap, j = [], [], 0
        for t in times:
            while j < len(self.host) and self.host[j][1] <= t:
                name, s, e = self.host[j]
                heapq.heappush(heap, (-s, e, name))
                j += 1
            while heap and heap[0][1] < t:  # ended: times only grow, so it never runs again
                heapq.heappop(heap)
            out.append(heap[0][2] if heap else "python")
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle stretches
        summed by what the host was doing at their middle."""
        ops = defaultdict(float)
        for name, s, e in self.device:
            ops[name[:NAME_CHARS]] += e - s
        idle = defaultdict(float)
        gaps = self.idle_gaps()
        for (s, e), name in zip(gaps, self.hosts_at([0.5 * (s + e) for s, e in gaps])):
            idle[name[:NAME_CHARS]] += e - s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


class Profiler:
    """``torch.profiler`` over the window; ``trace`` is set once it stops."""

    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.trace: Trace | None = None

    def start(self) -> None:
        self._prof.start()

    @contextmanager
    def window(self):
        import torch

        with torch.profiler.record_function(WINDOW):
            yield

    def stop(self) -> Trace:
        self._prof.stop()
        self.trace = reduce_events(self._prof.profiler.kineto_results.events())
        return self.trace


def reduce_events(events) -> Trace:
    """A :class:`Trace` of the kineto events of a profiled window."""
    from torch._C._autograd import DeviceType

    cuda = DeviceType.CUDA
    win = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        on_device = ev.device_type() == cuda
        if name == WINDOW:
            if not on_device:
                win = (ev.start_ns(), ev.end_ns())
        elif not ev.is_user_annotation():
            (device if on_device else host).append((name, ev.start_ns(), ev.end_ns()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    t0, t1 = win
    sec = lambda items: sorted(  # noqa: E731
        ((n, (s - t0) * 1e-9, (e - t0) * 1e-9) for n, s, e in items if e > t0 and s < t1), key=lambda x: x[1])
    return Trace(window_s=(t1 - t0) * 1e-9, device=sec(device), host=sec(host))
