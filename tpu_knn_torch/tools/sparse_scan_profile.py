"""The sparse exact scan on one CUDA card: csrc/sparse_qdense.cu's time over
a whole corpus at several launch widths, and the scan's wall and its top-k
merges at several chunk sizes (chip_smoke.py's phase 18 holds the kernel
against its plain version); or, with ``--turns``, one checkout's kernel at
the 1M cell and at a dense-table shape, to compare two checkouts in turns.

Run it from the root of a checkout:

    PYTHONPATH=. python3 tpu_knn_torch/tools/sparse_scan_profile.py

It builds the kernel, makes ``sparse_like(rows + 512, vocab, nnz=64,
seed=0)`` (1,000,000 corpus rows, vocabulary 60,000: the 1M
``cosinesimil_sparse`` cell of chip_smoke.py's phase 18), and prints, with
the card's name and power limit:

* ``[kernel]``: the kernel over every row of the corpus in launches of
  each ``--chunks`` width (CUDA events, mean of ``--reps``), beside
  ``torch.sparse.mm`` of the dots alone (CSR rows times the densified
  [V, Q] query table, which the scan itself never builds);
* ``[scan]``: ``Index("cosinesimil_sparse", method="seq_search",
  chunkSize=w)`` for each width (4080 is the scan's own on the card):
  the median of ``--reps`` synced walls of ``knn_query_batch`` at k=10,
  its kernel launches, whether its ids and distances equal the first
  width's (ties included), and the time of its top-k merges alone
  (``ops/topk.merge_topk`` of a [Q, w] block, once a chunk).

With ``--turns LABEL`` it times the checkout that is first on the module
path instead, so that two checkouts can be compared on one card in turns
(parent, change, change, parent), the parent unpacked by ``git archive``:

    PYTHONPATH=<parent> python3 tpu_knn_torch/tools/sparse_scan_profile.py --turns parent
    PYTHONPATH=. python3 tpu_knn_torch/tools/sparse_scan_profile.py --turns change

Each run builds that checkout's kernel and prints its library's path and
its registers and spills, then ``[turns]`` lines for the 1M cell, bench.py's
config 5 (``sparse_like(102_048, vocab=30_000, nnz=64, seed=0)``, 100,000
rows) and the dense-table cell (``sparse_like(DENSE_ROWS + 512,
vocab=1_024, nnz=64, seed=0)``: 7.6% of its (element, query) pairs
non-zero against 0.86% at the 1M cell): the ``cosine`` kernel over every
row in 4080-row launches, the scan's own (CUDA events, mean of ``--reps``;
a loop the host may enqueue slower than the card runs it), on the query
side that checkout's scan attaches (its densified [V, Q] table, or the
postings since the kernel walks them), whose build is timed apart, and
the scan's wall (``knn_query_batch`` at k=10, median of ``--reps``) with
the card's busy time in one (``torch.profiler``, every kernel and copy).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np

#: the dense-table cell: rows and vocabulary
DENSE_ROWS, DENSE_VOCAB = 100_000, 1_024
#: bench.py's sparse config 5 (chip_smoke.py's phase 18 (a)): rows and vocabulary, its queries the
#: first 512 of the 2048 rows after the corpus
CONFIG5_ROWS, CONFIG5_VOCAB = 100_000, 30_000
#: the scan's launch width on the card (spaces/sparse.CARD_CHUNK)
CHUNK = 4080


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


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _build(label: str) -> None:
    from tpu_knn_torch.ops import groupmin as GM

    t0 = time.perf_counter()
    lib = GM.build_all(("sparse_qdense",))["sparse_qdense"]
    print(f"[build] {label} sparse_qdense {lib} in {time.perf_counter() - t0:.1f} s: "
          + " | ".join(ln.strip() for ln in GM.build_log.get("sparse_qdense", "").splitlines()
                       if "registers" in ln or "spill" in ln or "warning" in ln.lower()), flush=True)


def _scan_index(corpus, chunk: int):
    from tpu_knn_torch import DataKind, Index, Params

    ix = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    ix.add_sparse_batch(corpus, ids=range(len(corpus)))
    ix.build_index(Params(chunkSize=chunk))
    return ix


def _query_side(space, queries, data, chunk: int):
    """(query side, query norms, ms to build it) as the checkout's scan attaches them: the postings
    (``q_post``) or, before them, the densified table (``q_dense_t``)."""
    import torch

    qenc = space.encode_queries(queries)
    xc = space.slice_data(data, 0, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = space.densify_queries(qenc, xc, scan=True)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    side = full["q_post"] if "q_post" in full else full["q_dense_t"]
    return side, full["qnorm"], build_ms


def _kernel_over(S, side, qn, data, width: int):
    """The cosine kernel over every row of ``data`` in launches of ``width`` rows."""
    n_pad = data.ids.shape[0]

    def run():
        for s in range(0, n_pad, width):
            S.qdense_dists("cosine", side, data.col[s:s + width], data.val[s:s + width], qn, None, None,
                           data.extra["pad"][s:s + width])
    return run


def _wall_ms(ix, queries, reps: int) -> float:
    """The median of ``reps`` synced walls of ``knn_query_batch`` at k=10, ms, after a warm call."""
    import torch

    ix.knn_query_batch(queries, 10)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ix.knn_query_batch(queries, 10)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def _busy_ms(fn) -> float:
    """The card's busy time in one call of ``fn``: the device time of every kernel and copy in
    torch.profiler's trace, ms (the wall less it is the card's idle time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()) / 1e3


def time_turn(label: str, reps: int, rows: int, vocab: int, nq: int) -> None:
    import torch

    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.ops import sparse as S

    smi = _smi()
    _build(label)
    for cell, n, v in (("1M", rows, vocab), ("config5", CONFIG5_ROWS, CONFIG5_VOCAB),
                       ("dense", DENSE_ROWS, DENSE_VOCAB)):
        pts = sparse_like(n + (2048 if cell == "config5" else nq), vocab=v, nnz=64, seed=0)
        queries = pts[n:n + nq]
        ix = _scan_index(pts[:n], CHUNK)
        space, data = ix.method.space, ix.method.data
        side, qn, build_ms = _query_side(space, queries, data, CHUNK)
        GM.reset_launches()
        ms = _events_ms(_kernel_over(S, side, qn, data, CHUNK), reps)
        launches = GM.launches["sparse_qdense_cosine"] // (reps + 1)
        kind = "table" if torch.is_tensor(side) else "postings"
        wall = _wall_ms(ix, queries, reps)
        busy = _busy_ms(lambda: ix.knn_query_batch(queries, 10))
        print(f"[turns] {label} {cell}: cosine over {data.ids.shape[0]} rows ({int(data.length.sum())} elements, "
              f"vocab {v}) x {nq} queries in {launches} launches of {CHUNK} rows: {ms:.3f} ms (CUDA events, mean "
              f"of {reps}); query side: {kind}, built in {build_ms:.3f} ms (host clock, synced); the scan's wall "
              f"{wall:.2f} ms (knn_query_batch, k=10, median of {reps}), the card busy {busy:.2f} ms of one "
              f"(torch.profiler, every kernel and copy); {smi}", flush=True)
        del ix, space, data, side
        torch.cuda.empty_cache()


def profile(args) -> None:
    import torch

    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.ops import sparse as S
    from tpu_knn_torch.ops import topk as T

    smi = _smi()
    _build("")
    n, nq = args.rows, args.queries
    pts = sparse_like(n + nq, vocab=args.vocab, nnz=64, seed=0)
    corpus, queries = pts[:n], pts[n:]
    widths = [int(w) for w in args.chunks.split(",")]
    base = None
    for w in widths:
        ix = _scan_index(corpus, w)
        space, data = ix.method.space, ix.method.data
        if base is None:  # the kernel's times, on the first width's encode
            post, qn, _ = _query_side(space, queries, data, w)
            e = int(data.length.sum())
            for cw in widths:
                ms = _events_ms(_kernel_over(S, post, qn, data, cw), args.reps)
                print(f"[kernel] cosine over {data.ids.shape[0]} rows ({e} elements) x {nq} queries in launches of "
                      f"{cw} rows: {ms:.3f} ms (mean of {args.reps}); {smi}", flush=True)
            lens = data.length[:n].long()
            crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
            real = (data.col[:n] >= 1) & (data.col[:n] < S.PAD_X)
            table = S.postings_table(post)
            xs = torch.sparse_csr_tensor(crow, data.col[:n][real].long() - 1, data.val[:n][real],
                                         size=(n, table.shape[0]))
            lib_ms = _events_ms(lambda: torch.sparse.mm(xs, table), args.reps)
            print(f"[kernel] torch.sparse.mm of the dots alone over {n} rows: {lib_ms:.3f} ms (mean of "
                  f"{args.reps}); {smi}", flush=True)
            del xs, crow, real, table
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=60_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--chunks", default="4080,4096,16384,65536")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", metavar="LABEL", help="time the checkout first on the module path, for turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sparse_scan_profile needs a CUDA card")
    if args.turns:
        time_turn(args.turns, args.reps, args.rows, args.vocab, args.queries)
    else:
        profile(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
