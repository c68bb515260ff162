"""The sparse exact scan on one CUDA card: csrc/sparse_qdense.cu's time over
a whole corpus at several launch widths, and the scan's wall and its top-k
merges at several chunk sizes (chip_smoke.py's phase 18 holds the kernel
against its plain version).

Run it from the root of a checkout:

    PYTHONPATH=. python3 tpu_knn_torch/tools/sparse_scan_profile.py

It builds the kernel, makes ``sparse_like(rows + 512, vocab, nnz=64,
seed=0)`` (1,000,000 corpus rows, vocabulary 60,000: the 1M
``cosinesimil_sparse`` cell of chip_smoke.py's phase 18), and prints, with
the card's name and power limit:

* ``[kernel]``: the kernel over every row of the corpus in launches of
  each ``--chunks`` width (CUDA events, mean of ``--reps``), beside
  ``torch.sparse.mm`` of the dots alone;
* ``[scan]``: ``Index("cosinesimil_sparse", method="seq_search",
  chunkSize=w)`` for each width (4080 is the scan's own on the card):
  the median of ``--reps`` synced walls of ``knn_query_batch`` at k=10,
  its kernel launches, whether its ids and distances equal the first
  width's (ties included), and the time of its top-k merges alone
  (``ops/topk.merge_topk`` of a [Q, w] block, once a chunk).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    import torch

    from tpu_knn_torch import DataKind, Index, Params
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.ops import sparse as S
    from tpu_knn_torch.ops import topk as T

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=60_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--chunks", default="4080,4096,16384,65536")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sparse_scan_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    GM.build_all(("sparse_qdense",))
    print(f"[build] sparse_qdense in {time.perf_counter() - t0:.1f} s: "
          + " | ".join(ln.strip() for ln in GM.build_log.get("sparse_qdense", "").splitlines()
                       if "registers" in ln or "spill" in ln or "warning" in ln.lower()), flush=True)

    n, nq = args.rows, args.queries
    pts = sparse_like(n + nq, vocab=args.vocab, nnz=64, seed=0)
    corpus, queries = pts[:n], pts[n:]
    widths = [int(w) for w in args.chunks.split(",")]
    base = None
    for w in widths:
        ix = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
        ix.add_sparse_batch(corpus, ids=range(n))
        ix.build_index(Params(chunkSize=w))
        space, data = ix.method.space, ix.method.data
        if base is None:  # the kernel's times, on the first width's encode
            qenc = space.densify_queries(space.encode_queries(queries), space.slice_data(data, 0, w), scan=True)
            e = int(data.length.sum())
            table, qn = qenc["q_dense_t"], qenc["qnorm"]
            for cw in widths:
                def run(cw=cw):
                    for s in range(0, data.ids.shape[0], cw):
                        S.qdense_dists("cosine", table, data.col[s:s + cw], data.val[s:s + cw], qn, None, None,
                                       data.extra["pad"][s:s + cw])
                ms = _events_ms(run, args.reps)
                print(f"[kernel] cosine over {data.ids.shape[0]} rows ({e} elements) x {nq} queries in launches of "
                      f"{cw} rows: {ms:.3f} ms (mean of {args.reps}); {smi}", flush=True)
            lens = data.length[:n].long()
            crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
            real = (data.col[:n] >= 1) & (data.col[:n] < S.PAD_X)
            xs = torch.sparse_csr_tensor(crow, data.col[:n][real].long() - 1, data.val[:n][real],
                                         size=(n, table.shape[0]))
            lib_ms = _events_ms(lambda: torch.sparse.mm(xs, table), args.reps)
            print(f"[kernel] torch.sparse.mm of the dots alone over {n} rows: {lib_ms:.3f} ms (mean of "
                  f"{args.reps}); {smi}", flush=True)
            del xs, crow, real
        GM.reset_launches()
        d, i = ix.knn_query_batch(queries, 10)
        launches = sum(GM.launches[k] for k in GM.SPARSE_QDENSE)
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ix.knn_query_batch(queries, 10)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        blk = torch.rand((nq, w), device="cuda")
        fd = torch.full((nq, 10), float("inf"), device="cuda")
        fi = torch.full((nq, 10), -1, dtype=torch.int64, device="cuda")
        cols = torch.arange(w, device="cuda").expand(nq, w)
        chunks = data.ids.shape[0] // w
        merge_ms = _events_ms(lambda: [T.merge_topk(fd, fi, blk, cols, 10) for _ in range(chunks)], args.reps)
        same = "" if base is None else (
            f", ids {'equal' if np.array_equal(i, base[1]) else 'DIFFER'} and distances "
            f"{'equal' if np.array_equal(d, base[0]) else 'DIFFER'} to chunkSize={widths[0]}'s")
        base = base or (d, i)
        print(f"[scan] cosinesimil_sparse {n} rows padded to {data.ids.shape[0]}, {nq} queries, k=10, "
              f"chunkSize={w}: median of {args.reps} {statistics.median(walls):.2f} ms, {launches} kernel launches"
              f"{same}; its {chunks} top-k merges alone {merge_ms:.3f} ms (CUDA events, mean of {args.reps}); "
              f"{smi}", flush=True)
        del ix, space, data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
