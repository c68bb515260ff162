"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference.

The system under test is ``tpu_knn_torch`` through its public API
(``Index``): the harness hands it the inputs of ``data.py`` and takes back
its answers. Everything else here (traffic, timing, the trace's reduction,
the reference) is the benchmark's own.

A configuration gives the index: ``space``, ``space_params``, ``method``,
``data_type``, ``index_kwargs`` (further keyword arguments of ``Index``,
such as ``mesh``), ``index_params`` (``build_index``'s), ``query_params``
(``set_query_time_params``'), and ``check``, the comparison that decides
``correct``: ``knnbench/checks/<check>.py``, whose ``numbers(run)`` gives
each number compared (lower is better) against
``knnbench/limits/<cell>.json``.

A traffic mix is a JSON file of parameters:

* ``kind``: the entry it drives, ``knnbench/kinds/<kind>.py`` (``knn``:
  ``Index.knn_query_batch_async``; ``range``: ``Index.range_query_batch``),
  which reads the kind's own keys;
* ``batch`` queries a batch, cycling over a pool of ``pool_batches``
  batches drawn from the seed (the port has no result cache, so a repeated
  batch is real work);
* ``warmup_rounds``: passes over the pool before the window.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from . import hygiene
from .data import Inputs, make_inputs
from .reference import Reference
from .registry import Cell, find


@dataclass
class Run:
    """What the metrics' readers and the checks read."""

    cell: Cell
    inputs: Inputs
    device: torch.device
    #: the traffic kind's module, and the arguments its ``prepare`` worked out
    kind: object = None
    args: dict = field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    #: seconds from dispatch to the answer on the host, a batch
    latencies: list = field(default_factory=list)
    #: pool batch of each batch answered in the window
    pool_index: list = field(default_factory=list)
    queries_done: int = 0
    peak_window_bytes: int | None = None
    trace: object = None
    #: pool batch -> the distinct answers the window returned for it
    answers: dict = field(default_factory=dict)
    #: the float64 reference over the inputs, built once the program's state is freed
    reference: Reference | None = None


class _Tally:
    """Queries dispatched and queries whose batch failed."""

    attempted = 0
    failed = 0

    def fail(self, n: int) -> None:
        traceback.print_exc(file=sys.stderr)
        self.failed += n


def _digest(ans) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    stack = [ans]
    while stack:
        a = stack.pop()
        if isinstance(a, (list, tuple)):
            stack.extend(reversed(a))
        else:
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype, a.shape)).encode())
            h.update(a.tobytes())
    return h.digest()


def distinct_answers(records: list) -> dict:
    """Pool batch -> its distinct answers: every answer of the window is
    judged, an answer equal byte for byte to one already judged once."""
    seen, out = set(), defaultdict(list)
    for b, _, _, ans in records:
        if ans is None:
            continue
        key = (b, _digest(ans))
        if key not in seen:
            seen.add(key)
            out[b].append(ans)
    return dict(out)


def build_index(cell: Cell, inputs: Inputs, device):
    """The program's index over the corpus, built, through its public API."""
    from tpu_knn_torch import Index, Params

    cfg = cell.config
    idx = Index(cfg["space"], Params(cfg.get("space_params", {})), method=cfg["method"],
                data_type=cfg["data_type"], device=device, **cfg.get("index_kwargs", {}))
    if inputs.kind == "dense":
        idx.add_dense_batch(inputs.api_corpus(), ids=inputs.ids)
    else:
        idx.add_sparse_batch(inputs.api_corpus(), ids=inputs.ids)
    idx.build_index(Params(cfg.get("index_params", {})))
    if "query_params" in cfg:
        idx.set_query_time_params(Params(cfg["query_params"]))
    return idx


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> tuple[dict, list]:
    """One run. Returns (the result line's object, the compared numbers'
    lines for standard error). ``t0``: the process's start on the
    ``time.perf_counter`` clock."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = cell.traffic
    clock = _Clock()
    clock.laps["imports_s"] = clock.start - t0
    inputs = make_inputs(cell.config, traffic, seed, device)
    _sync(device)
    clock.mark("data_s")
    run = Run(cell=cell, inputs=inputs, device=device, kind=find("kinds", traffic["kind"], cell.root))
    run.args = run.kind.prepare(cell, inputs, device)  # the reference's work: not set-up's
    prepare_s = clock.mark("prepare_s")
    _free(device)
    if cuda:  # the peaks below are the program's: its build, warm-up and window
        torch.cuda.reset_peak_memory_stats(device)
    idx = build_index(cell, inputs, device)
    _sync(device)
    clock.mark("add_build_s")
    batches = [inputs.api_batch(b) for b in range(inputs.pool)]
    warm = int(traffic.get("warmup_rounds", 1)) * inputs.pool
    run.kind.drive(idx, batches, traffic, run.args, lambda i: i < warm, _Tally())
    _sync(device)
    clock.mark("warmup_s")
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from .trace import Profiler

        prof = Profiler()
        prof.start()
    tally = _Tally()
    t_first = time.perf_counter()
    run.setup_s = t_first - t0 - prepare_s
    deadline = t_first + seconds
    with prof.window() if prof is not None else contextlib.nullcontext():
        records = run.kind.drive(idx, batches, traffic, run.args, lambda i: time.perf_counter() < deadline, tally)
    _sync(device)
    t_last = max([r[2] for r in records], default=time.perf_counter())
    run.window_s = t_last - t_first
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    clock.mark("window_s")
    if prof is not None:
        run.trace = prof.stop()
        clock.mark("trace_s")
    done = [r for r in records if r[3] is not None]
    run.latencies = [r[2] - r[1] for r in done]
    run.pool_index = [r[0] for r in done]
    run.queries_done = len(done) * inputs.batch
    run.answers = distinct_answers(records)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": max(setup_peak, run.peak_window_bytes or 0)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy()
        dev["window_s"] = run.trace.window_s
    del idx, batches, records, done
    _free(device)

    run.reference = Reference(inputs, cell.config["space"], device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = find("metrics", m["name"], cell.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = find("checks", cell.config["check"], cell.root).numbers(run)
    clock.mark("reference_s")
    limits = json.loads((cell.root / "knnbench" / "limits" / f"{cell.name}.json").read_text())
    checks = {name: {"value": v, "limit": float(limits[name])} for name, v in numbers.items()}
    correct = (tally.failed == 0 and run.queries_done > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": bool(correct), "attempted": tally.attempted, "failed": tally.failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    lines = [f"knnbench: seconds {json.dumps(clock.laps)}"]
    lines += [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    return result, lines


class _Clock:
    """Seconds between marks, by the name of the stretch that ends at each."""

    def __init__(self):
        self.laps, self._t = {}, time.perf_counter()
        self.start = self._t

    def mark(self, name: str) -> float:
        t = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + t - self._t
        self._t = t
        return self.laps[name]


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    from .registry import load_cell

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m knnbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"knnbench: {cell.name} needs {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = hygiene.forbidden()
    if bad:
        print(f"knnbench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
