"""Wall and device time of range search over 1,000,000 x 128 f32 rows on
one CUDA card, and the wall of the kNN batch (k=10) over the same index,
to compare two checkouts of the package on one machine, minutes apart.

Run it by path, with the checkout under test first on the module path:

    PYTHONPATH=. python3 tpu_knn_torch/tools/range_profile.py --label change
    PYTHONPATH=<other checkout> python3 tpu_knn_torch/tools/range_profile.py --label parent

in turns (parent, change, change, parent): the host's share of the wall
drifts from hour to hour, the device times do not. It builds
``Index("l2", method="seq_search")`` over ``sift_like(1_002_048, 128,
seed=0)``, takes the median 10th-neighbour distance of the 2048 queries as
the radius, and prints the median of ``--reps`` walls of
``range_query_batch`` and the device ms of the counts and the collect
pass, then the median of ``--reps`` walls of ``knn_query_batch``, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np


def main() -> int:
    import torch

    import tpu_knn_torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.methods.base import range_cap

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    xall = sift_like(args.rows + 2048, 128, seed=0)
    corpus, queries = xall[: args.rows], xall[args.rows:]
    idx = Index("l2", Params(dim=128), method="seq_search", device="cuda")
    idx.add_dense_batch(corpus)
    idx.build_index()
    d10, _ = idx.knn_query_batch(queries, 10)
    radius = float(np.median(d10[:, 9]))
    res = idx.range_query_batch(queries, radius)  # warm
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        idx.range_query_batch(queries, radius)
        walls.append((time.perf_counter() - t0) * 1e3)
    m = idx.method
    qenc = m.space.encode_queries(queries)
    cap = range_cap(max(len(r.ids) for r in res), m.data.ids.shape[0])

    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    counts = cuda_ms(lambda: SS._range_counts_device(m.space, qenc, m.data, radius, m._chunk, m.precision))
    collect = cuda_ms(lambda: SS._range_collect_device(m.space, qenc, m.data, radius, cap, m._chunk, m.precision))
    print(f"[range] {args.label} ({tpu_knn_torch.__path__[0]}): {args.rows} x 128 l2, Q=2048, radius {radius:.4f}, "
          f"{sum(len(r.ids) for r in res)} hits, cap {cap}: wall median of {args.reps} "
          f"{statistics.median(walls):.3f} ms (min {min(walls):.3f}, max {max(walls):.3f}); device ms "
          f"counts pass {counts:.3f}, collect pass {collect:.3f}; {smi}", flush=True)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        idx.knn_query_batch(queries, 10)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[knn] {args.label}: knn_query_batch Q=2048 k=10, wall median of {args.reps} "
          f"{statistics.median(walls):.3f} ms (min {min(walls):.3f}, max {max(walls):.3f}); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
