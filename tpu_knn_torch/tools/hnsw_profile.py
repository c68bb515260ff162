"""Where the time of the HNSW port goes on one CUDA card.

Run from the root of a checkout: ``python3 -m tpu_knn_torch.tools.hnsw_profile``
(``--rows 20000`` for a short run), or by path with another checkout first on
the module path (``PYTHONPATH=<checkout> python3
tpu_knn_torch/tools/hnsw_profile.py``) to time that checkout with this tool.
It builds ``Index(space, Params(dim=128))`` (``--space``, default l2; the
default method, hnsw) over ``sift_like(rows + 2048, 128, seed=0)`` with
M=16, efConstruction=200 (``--efc``), waveSize=1024 and prints, each line with
the card's name and power limit:

  * build seconds and peak memory, ``check_graph``;
  * recall@10 against the exact scan and the wall of a 2048-query batch at
    efSearch 10..200, with the loops' iterations and host syncs;
  * the device ms of one beam iteration's parts at each efSearch, as
    stand-alone ops at the search's shapes: the row gather, the batched
    product, the three sorts (l2 only: the product is its scorer);
  * with ``--profile-waves``, a second build under ``tracing.enable()``
    whose wave step's ``hnsw.wave.*`` spans give each phase's host and
    device ms a wave (utils/tracing.py; no sync at the phase edges):
    ``--space l1 --rows 20000 --efc 100`` gives the ``pairs`` ms of the
    elementwise kernel's pair form at the build's own shapes;
  * with ``--async``, the wall of one 2048-query batch at efSearch=20 run
    four ways in turns (``knn_query_batch`` on the caller's thread, the same
    under a side stream, the same on a helper thread, and through
    ``knn_query_batch_async`` one batch at a time), to tell the stream, the
    thread and the dispatcher apart, then 8 batches in flight against 8
    serial calls.

With ``--nnd`` it builds bench.py's SIFT-1M parameters instead (1,000,000
rows by default, M=16, efConstruction=100, waveSize=1024,
replicateNeighbors=1, nbrStoreDtype="int8"; buildAlgo "auto" routes to
NN-descent) with ``nndProfile=1``, and prints the wall of each phase mark
(init_exact, descent_sweeps, final_exact, then pl_prune, pl_rev, pl_shrink
and link0 of the first link, uppers, polish0, and the second link's marks
ending in link1; a device sync at each), the updates of each descent sweep
and the repaired node count.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np


def _cuda_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def beam_parts_ms(vecs, nq: int, ef: int, m0: int = 32, expand: int = 4) -> dict:
    """Device ms of the parts of one beam iteration at [nq, expand*m0]
    candidates and a beam of ``ef``, as stand-alone ops."""
    import torch

    from tpu_knn_torch.ops.distance import batched_dot
    from tpu_knn_torch.ops.topk import smallest_k

    dev = vecs.device
    g = torch.Generator(device=dev).manual_seed(0)
    kc, wd = expand * m0, max(ef, expand) + expand * m0
    ids = torch.randint(0, vecs.shape[0], (nq, kc), device=dev, generator=g, dtype=torch.int32)
    q = vecs[:nq].contiguous()
    rows = vecs[ids]
    all_i = torch.randint(0, vecs.shape[0], (nq, wd), device=dev, generator=g, dtype=torch.int32)
    all_d = torch.rand((nq, wd), device=dev, generator=g)
    beam_d = torch.rand((nq, max(ef, expand)), device=dev, generator=g)
    return {
        "gather_rows": _cuda_ms(lambda: vecs[ids]),
        "batched_dot": _cuda_ms(lambda: batched_dot(q, rows)),
        "sort_pick_parents": _cuda_ms(lambda: smallest_k(beam_d, expand)),
        "sort_by_id": _cuda_ms(lambda: torch.sort(all_i, dim=1, stable=True)),
        "sort_by_distance": _cuda_ms(lambda: torch.sort(all_d, dim=1, stable=True)),
    }


def async_split(idx, queries, k: int, smi: str, rounds: int = 7) -> dict:
    """Median wall ms of one batch at efSearch=20, each way in turn."""
    import statistics
    import threading

    import torch

    from tpu_knn_torch import Params

    idx.set_query_time_params(Params(efSearch=20))
    side = torch.cuda.Stream()

    def caller():
        idx.knn_query_batch(queries, k)

    def side_stream():
        with torch.cuda.stream(side):  # ends in a .cpu() on the side stream
            idx.knn_query_batch(queries, k)

    def helper_thread():
        t = threading.Thread(target=caller)
        t.start()
        t.join()

    def dispatched():
        idx.knn_query_batch_async(queries, k).result()

    def in_flight():
        for f in [idx.knn_query_batch_async(queries, k) for _ in range(8)]:
            f.result()

    def serial():
        for _ in range(8):
            idx.knn_query_batch(queries, k)

    ways = {"caller": caller, "side_stream": side_stream, "helper_thread": helper_thread,
            "dispatched": dispatched, "8_in_flight": in_flight, "8_serial": serial}
    times: dict = {w: [] for w in ways}
    for fn in ways.values():
        fn()  # warm
    for _ in range(rounds):
        for w, fn in ways.items():
            t0 = time.perf_counter()
            fn()
            times[w].append((time.perf_counter() - t0) * 1e3)
    med = {w: statistics.median(t) for w, t in times.items()}
    print(f"[async split] one {len(queries)}-query batch at efSearch=20, median ms of {rounds} in turns: "
          f"{json.dumps({w: round(m, 3) for w, m in med.items()})}; {smi}", flush=True)
    return med


def nnd_log_summary(lines) -> tuple[list, list, list]:
    """(phase walls [(name, s)], updates per descent sweep, repaired nodes
    per link) from the log lines of an NN-descent build with nndProfile=1."""
    phases = [(a, float(b.rstrip("s"))) for a, b in
              (ln.split("phase ")[1].rsplit(": ", 1) for ln in lines if ln.startswith("hnsw nnd phase "))]
    sweeps = [int(ln.split(": ")[1].split()[0]) for ln in lines if ln.startswith("hnsw nnd sweep ")]
    repaired = [int(ln.split(" of ")[1].split()[0]) for ln in lines if "repaired reachability" in ln]
    return phases, sweeps, repaired


def main() -> int:
    import torch

    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.utils import logging as L
    from tpu_knn_torch.utils import tracing

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, help="corpus rows (default 100,000; 1,000,000 with --nnd)")
    ap.add_argument("--space", default="l2", help="the dense space of the index (default l2)")
    ap.add_argument("--efc", type=int, help="efConstruction (default 200; 100 with --nnd)")
    ap.add_argument("--profile-waves", action="store_true")
    ap.add_argument("--nnd", action="store_true", help="the NN-descent build at SIFT-1M, phase by phase")
    ap.add_argument("--async", dest="split", action="store_true",
                    help="one batch searched through the caller, a side stream, a thread and the dispatcher")
    args = ap.parse_args()
    args.rows = args.rows or (1_000_000 if args.nnd else 100_000)
    args.efc = args.efc or (100 if args.nnd else 200)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nq, k = 2048, 10
    xall = sift_like(args.rows + nq, 128, seed=0)
    corpus, queries = xall[: args.rows], xall[args.rows:]
    build = Params(M=16, efConstruction=args.efc, waveSize=1024)
    if args.nnd:
        build = Params(M=16, efConstruction=args.efc, waveSize=1024, replicateNeighbors=1, nbrStoreDtype="int8",
                       nndProfile=1)
    lines: list = []

    def make(profile=False):
        idx = Index(args.space, Params(dim=128), device="cuda")
        idx.add_dense_batch(corpus)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if profile:
            tracing.reset()
            tracing.enable()
        L.LOGGER.set_custom(lambda level, msg: (lines.append(msg), print(f"[log] {msg}", flush=True)))
        try:
            idx.build_index(build)
        finally:
            tracing.disable()
            L.LOGGER.set_stderr()
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    G.reset_counters()
    idx, build_s, peak = make()
    print(f"[build] {args.space} {args.rows} x 128, {build.as_dict()}: {build_s:.2f} s, peak allocated "
          f"{peak / 2**30:.3f} GiB, check_graph {idx.method.check_graph()}, levels "
          f"{len(idx.method._upper) + 1}, loop counters {json.dumps(G.counters)}; {smi}", flush=True)
    if args.nnd:
        phases, sweeps, repaired = nnd_log_summary(lines)
        print(f"[nnd] phase walls (s, in order, one sync each): {json.dumps(phases)}; descent updates per sweep "
              f"{sweeps}; repaired nodes per link {repaired}; {smi}", flush=True)

    exact = Index(args.space, Params(dim=128), method="seq_search", device="cuda")
    exact.add_dense_batch(corpus)
    _, gi = exact.knn_query_batch(queries, k)
    del exact

    def recall(i):
        return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(gi, i)]))

    for ef in (10, 14, 20, 50, 100, 200):
        idx.set_query_time_params(Params(efSearch=ef))
        _, i = idx.knn_query_batch(queries, k)  # warm
        G.reset_counters()
        idx.knn_query_batch(queries, k)
        counts = dict(G.counters)
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            idx.knn_query_batch(queries, k)
            best = min(best, time.perf_counter() - t0)
        print(f"[search] efSearch={ef}: recall@{k} {recall(i):.4f}, best of 3 {best * 1e3:.2f} ms, "
              f"{nq / best:.0f} qps, counters {json.dumps(counts)}; {smi}", flush=True)
    for ef in (10, 20, 50, 100, 200) if args.space == "l2" else ():
        parts = beam_parts_ms(idx.method.data.vecs, nq, ef)
        print(f"[beam parts] efSearch={ef}, device ms per iteration: "
              f"{json.dumps({a: round(b, 4) for a, b in parts.items()})}; {smi}", flush=True)
    if args.split:
        async_split(idx, queries, k, smi)
    if args.profile_waves:
        del idx
        torch.cuda.empty_cache()
        idx, prof_s, _ = make(profile=True)
        waves = -(-args.rows // 1024)
        phases = {name[len("hnsw.wave."):]: t for name, t in tracing.totals().items() if name.startswith("hnsw.wave.")}
        print(f"[waves] traced build {prof_s:.2f} s (plain {build_s:.2f} s), {waves} waves; host ms, device ms "
              f"per wave: {json.dumps({a: [round(t['host_ms'] / waves, 2), round((t['device_ms'] or 0) / waves, 2)] for a, t in phases.items()})} "
              f"('pairs' and 'select' are also inside 'reverse'); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
