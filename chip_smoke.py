#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_knn_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc (under CUDA_HOME or /usr/local/cuda, or on PATH) and the
checkout's sources; it imports neither jax nor tpu_knn. Phases, each
printed as it ends, each fatal on failure:

 1. environment: torch/CUDA versions, the card's name and power limit;
    IEEE f32 matmuls (no TF32) required;
 2. build: compile csrc/groupmin.cu (f32), csrc/groupmin_wgmma_i8.cu
    (int8) and csrc/groupmin_wgmma.cu (bf16x3, bf16) for sm_90a, one nvcc
    each, side by side; registers and spills of every kernel and template
    instance, any ptxas warning or remark on the wgmma pipeline, the build
    time;
 3. the f32 group-min kernel against its plain PyTorch version computed in
    float64, on 131072 sift_like rows, Q in {2048, 1000 (ragged)}; then,
    on the same rows, the int8 kernel bit-equal to its plain version and
    the bf16x3 and bf16 kernels within 1e-5 (relative to the magnitude)
    of theirs and within the certificate's eps of the f32 kernel; then the
    same two checks of the bf16x3 and bf16 kernels at the edge shapes
    Q in {1, 7, 256, 1000, 2048}, N in {128, 128*63, 20096},
    D in {24, 128, 136, 384, 960}; and the int8 kernel bit-equal to its
    plain version at the same Q and N with D in {16, 48, 96, 128, 144,
    384, 640, 960, 2048} (every layout of its plan, printed per D), at a
    power-of-two scale and at another, with rows of all -128 and all 127
    and x_term = 1e30 on trailing rows;
 4. the main path: Index("l2", Params(dim=128), method="seq_search",
    device="cuda") over 1,000,000 sift_like rows (the SIFT-1M shape of
    ann-benchmarks' sift-128-euclidean), 2048 queries at k=10, on the
    two-pass route, with the kernel's launch count, build and query times,
    a per-stage breakdown and the kernel's time against the plain version;
 5. a float64 oracle (plain chunked torch product, independent of the
    code under test) for all 2048 queries at k=10 and k=100, for one
    knn_query, and for both routes at small sizes (3000 rows single-pass,
    20000 rows two-pass);
 6. the int8 path: Index("l2sqr_sift", ..., data_type="dense_uint8_vector",
    dist_type="int", device="cuda") over the uint8 rounding of the same
    1M rows (SIFT's native byte format), 2048 queries at k=10, against an
    exact integer oracle, with times, a breakdown, kernel vs plain and
    the kernel in turns with the f32 kernel (f32, int8, int8, f32);
 7. the reduced tiers: the 1M x 128 f32 index built with pass1Precision
    "high" and then "bfloat16", k=10 and k=100, bit-identical to the f32
    tier, with the certified fraction, the redone blocks and times; each
    reduced kernel at those shapes within 1e-5 of its plain version and
    within the certificate's eps of the f32 kernel;
 8. a forced fallback: duplicated rows across groups make the
    certificate fail in the first 256-query block, which re-runs the f32
    kernel, while under "high" the second block keeps its certified
    reduced selection; ids still match the float64 oracle except on ties.
 8b. gist-960's width: Index("l2", Params(dim=960)) over 20,096
    sift_like rows, 256 queries, the f32 tier against the float64 oracle
    and "high"/"bfloat16" (K chunks in the kernel) bit-identical to it.

Added phases (the first two run right after phase 6, on the indexes of
phases 4 and 6, before phase 7 rebuilds phase 4's index):

 9. range: range_query_batch of the 2048 queries on phase 4's 1M l2
    index, at the median over queries of the k=10 result's 10th distance,
    against a chunked float64 oracle (counts and id sets equal except for
    points whose f64 distance lies within the f32 error bound of the
    radius); then on phase 6's l2sqr_sift index at the integer radius of
    its 10th distance, against the exact integer oracle, and range_query
    of one point against its batch row; the largest count, the cap, a
    median of 5, the peak memory and the device ms of the two passes;
10. persist: phase 4's index saved with save_data True and False, loaded
    back with Index.load(path, load_data, device="cuda") in both load
    modes; knn_query_batch and knn_query_batch_async results
    bit-identical to those before the save; save and load seconds and
    artifact sizes;
11. angular (full width): the glove-100-angular shape,
    eval.datasets.clustered(1_185_562, 100, seed=1), the first 1,183,514
    rows the corpus and the last 2048 the queries, through
    Index("angulardist", Params(dim=100), method="seq_search",
    device="cuda") at k=10 and k=100 on the two-pass route, against a
    float64 oracle on the cosine similarity of the normalized rows; the f32
    and bf16x3 kernels at these shapes (scale -1, no row terms) against
    their plain versions; pass1Precision "high" bit-identical to f32;
    cosinesimil and negdotprod at k=10 on the same data;
12. gold standard and metrics: GoldStandard over the angular corpus equal
    to the index's results, its cache round trip exact, and
    eval.metrics of the "high" results against it (recall 1, number
    closer 0);
13. precision: phase 5's 3000-row single-pass index with precision
    "high" (ids equal to the f64 oracle except on ties of the tier's
    error bound) and "bfloat16" (recall@10 against the f32 gold).

14. a NaN distance: 20,000 x 16 rows with +inf in row 7, k=5, two-pass
    route on the card: the f32 kernel's group mins (min.NaN.f32) NaN in
    the same cells as its plain version's (torch.min), and every query
    whose norm identity gives inf - inf gets row 7 first from
    knn_query_batch, as on the CPU; (the kernel edge sweep of phase 3
    also holds the f32, bf16x3 and bf16 kernels to their plain versions
    with an inf row, NaN cell for NaN cell);
15. hnsw, the default method: Index("l2", Params(dim=128), device="cuda")
    with no method= over sift_like(102_048, 128, seed=0) (100,000 corpus
    rows, 2048 queries: bench.py's HNSW cell), build_index(M=16,
    efConstruction=200, waveSize=1024) by insertion waves with the int8
    construction store; build seconds and peak memory; check_graph all
    zero; recall@10 against GoldStandard (which runs the f32 kernel) and
    qps (warm, best of 3) at efSearch 10, 14, 20, 50, 100, 200, recall
    >= 0.95 at 20 and >= 0.99 at 100; every distance within rtol 5e-3 of
    its float64 value; loop iterations, syncs and score mismatches per
    search; identical results with a sync every 8 iterations; range_query
    raises; save and Index.load(device="cuda") give identical answers;
    replicateNeighbors=1 (bf16 and int8) within 0.01 of the plain recall,
    distances exact, the store counted by memory_usage_bytes; at 20,000 x
    128 two builds from one seed give equal graphs and results, a reversed
    batch the reversed results, post=1 keeps check_graph zero; l2sqr_sift
    and angulardist over 20,000 rows (ramped head waves) return a
    self-query first and reach recall@10 >= 0.9 at efSearch=100.
16. nnd, the default index at SIFT-1M: Index("l2", Params(dim=128),
    device="cuda") over phase 4's 1,000,000 rows, build_index with
    bench.py's Params1M (M=16, efConstruction=100, waveSize=1024,
    replicateNeighbors=1, nbrStoreDtype="int8"; buildAlgo auto routes it
    to NN-descent) and nndProfile=1 (a device sync and a log line at each
    phase mark); build seconds, the phase split, the updates of each
    descent sweep, repaired nodes, peak memory, check_graph all zero and
    no node unreached from the entry; recall@10 against phase 4's exact
    ids (held to the float64 oracle) and qps (warm, best of 3) at
    bench.py's efSearch set 10-14, 20, 50, recall >= 0.95 at 20, every
    distance within rtol 5e-3 of its float64 value; then 20,000-row cells
    with buildAlgo="nndescent" below the threshold: the same seed twice
    (torch.equal on every level), l2sqr_sift on uint8 rows, cosinesimil on
    clustered rows, nndRevMode="slots", nndStoreDtype="float32" (the
    wide-row branch at D=128), nndPolishStore=0 and D=960 (the wide-row
    branch of the int8 store), each with check_graph all zero and
    recall@10 at efSearch=50 against GoldStandard.

Every [kernel] line at the main path's shapes prints the kernel's bound
(the larger of its bytes over 3.35 TB/s and its operations over the
tier's dense peak: 67 TFLOP/s f32, 989 bf16, 1,979 TOP/s int8) and its
share of it. No kernel lies on HNSW's own path, waves or NN-descent (their
loops are torch ops, as they are XLA ops in tpu_knn); it reaches the f32
kernel through GoldStandard and phase 4's exact ids. The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA card or any phase fails.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N_CORPUS = 1_000_000
N_QUERIES = 2048
DIM = 128
K = 10
N_KERNEL_CHECK = 131_072
U = 2.0 ** -24  # f32 unit roundoff


def _require(ok: bool, message) -> None:
    """Fail the run (unlike assert, not removed under python -O)."""
    if not ok:
        raise RuntimeError(message())


def _phase(name: str, t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    print(f"[phase] {name} done in {t - t0:.3f} s", flush=True)
    return t


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events, after one warm-up."""
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


def _ptxas_summary(log: str) -> list[str]:
    """'kernel: registers ..., spills ...' for each entry function of nvcc's
    -Xptxas=-v output (empty when the library came from the build cache);
    template arguments in angle brackets."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '.*?(groupmin_[a-z0-9]+_kernel|split_queries_kernel|image_queries_kernel)(I\w*)?", ln)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name, spill = m.group(1) + (f"<{','.join(args)}>" if args else ""), ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


def _ptxas_remarks(log: str) -> dict:
    """{"C75xx <template arguments>": count} of ptxas's remarks on the wgmma
    pipeline in nvcc's -Xptxas=-v output."""
    out: dict = {}
    for m in re.finditer(r"\((C75\d+)\).*?_kernel(I\w*?)EvNS", log):
        key = f"{m.group(1)} <{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
        out[key] = out.get(key, 0) + 1
    return out


#: dense peaks of one H100 SXM (NVIDIA's data sheet) per tier, and its HBM rate
PEAK_OPS = {"float32": 67e12, "int8": 1979e12, "high": 989e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _bound_ms(tier: str, q, x):
    """(least ms, "bytes" or "operations") of one group-min call: q, x and
    the two row terms read once and the [Q, N/128] mins written once, over
    the HBM rate, against its multiply-adds (x2; three bf16 products per
    pair for bf16x3) over the tier's dense peak."""
    qn, d = q.shape
    n = x.shape[0]
    nbytes = q.numel() * q.element_size() + x.numel() * x.element_size() + 4 * (qn + n) + 4 * qn * (n // 128)
    ops = 2.0 * qn * n * d * (3 if tier == "high" else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[tier]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _edge_sweep(dev, kernel_err):
    """The bf16x3 and bf16 kernels at the edge shapes of the wgmma design:
    Q in {1, 7, 256, 1000, 2048} (one partial 64-query tile up to 32 full
    ones), N in {128, 128*63, 20096} (one group; an odd group count, so a
    two-group corpus tile is half empty), D in {24, 128, 136, 384, 960}
    (k-step tails; one, two, three, six and fifteen 64-k slabs, which take
    each buffering mode of the kernel: at 384 one consumer warpgroup for
    bf16x3, at 960, gist's width, K chunks for both tiers). Each within
    1e-5 of the magnitude of its plain version and within the
    certificate's eps of the f32 kernel."""
    import torch
    from tpu_knn_torch.core.dataset import DenseDeviceData
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    nmax, qmax = 20096, 2048
    data = sift_like(nmax + qmax, 960, seed=2)
    worst = {tier: [0.0, 0.0] for tier in ("high", "bfloat16")}
    shapes = 0
    for d in (24, 128, 136, 384, 960):
        x_all = torch.from_numpy(np.ascontiguousarray(data[:nmax, :d])).to(dev)
        q_all = torch.from_numpy(np.ascontiguousarray(data[nmax:, :d])).to(dev)
        for n in (128, 128 * 63, nmax):
            x = x_all[:n]
            xt = (x * x).sum(1)
            slab = DenseDeviceData(vecs=x, ids=torch.arange(n, dtype=torch.int32, device=dev), count=n, dim=d)
            ensure_cert_metadata(slab)
            for nq in (1, 7, 256, 1000, qmax):
                q = q_all[:nq]
                qt = (q * q).sum(1)
                f32 = GM.fused_groupmin(q, x, qt, xt, -2.0)
                _, mag = _groupmin_bound(q, x, qt, xt, -2.0)
                for tier in ("high", "bfloat16"):
                    out = GM.fused_groupmin(q, x, qt, xt, -2.0, precision=tier)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, x, qt, xt, -2.0, precision=tier)
                    diff = (out.double() - ref.double()).abs()
                    rel = float((diff / mag).max())
                    eps = SS._pass1_eps(q, slab, -2.0, tier).double()
                    ratio = float(((out.double() - f32.double()).abs().amax(dim=1) / eps).max())
                    _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                             lambda: f"{tier} at Q={nq} N={n} D={d}: output not finite or not {tuple(ref.shape)}")
                    _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at Q={nq} N={n} D={d}: {rel} of the magnitude")
                    _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at Q={nq} N={n} D={d}: {ratio}")
                    kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
                    worst[tier] = [max(worst[tier][0], rel), max(worst[tier][1], ratio)]
                shapes += 1
    for tier, (rel, ratio) in worst.items():
        print(f"[kernel] {tier} edge sweep, {shapes} shapes (Q in 1, 7, 256, 1000, 2048; N in 128, 8064, "
              f"20096; D in 24, 128, 136, 384, 960): max |kernel - plain| relative to the magnitude {rel:.3g} (limit "
              f"1e-5); max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g} (limit 1)", flush=True)
    # a corpus row that holds +inf: under bf16x3 its split gives lo = inf - inf,
    # so every query's min over that row's group is NaN; under bf16 and f32 the
    # queries whose product is +inf give inf - inf there and the others +inf.
    # Each kernel carries those NaNs as its plain version does
    inf_shapes, inf_worst = 0, {tier: 0.0 for tier in ("float32", "high", "bfloat16")}
    for d in (24, 128, 960):
        for n in (128, nmax):
            x = torch.from_numpy(np.ascontiguousarray(data[:n, :d])).to(dev)
            for nq in (7, qmax):
                q = torch.from_numpy(np.ascontiguousarray(data[nmax:nmax + nq, :d])).to(dev)
                qt = (q * q).sum(1)
                _, mag = _groupmin_bound(q, x, qt, (x * x).sum(1), -2.0)
                xi = x.clone()
                xi[7, 3] = float("inf")
                xt = (xi * xi).sum(1)
                for tier in inf_worst:
                    out = GM.fused_groupmin(q, xi, qt, xt, -2.0, precision=tier)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, xi, qt, xt, -2.0, precision=tier)
                    nan_k, nan_p = torch.isnan(out), torch.isnan(ref)
                    fin = torch.isfinite(ref)
                    err = (out.double() - ref.double()).abs()[fin]
                    rel = float((err / mag.expand_as(out)[fin]).max()) if err.numel() else 0.0
                    _require(torch.equal(nan_k, nan_p) and bool(nan_p[:, 0].any())
                             and torch.equal(out[~fin & ~nan_p], ref[~fin & ~nan_p]) and rel <= 1e-5,
                             lambda: f"{tier} with an inf row at Q={nq} N={n} D={d}: NaN in {int(nan_k.sum())} "
                                     f"cells of the kernel, {int(nan_p.sum())} of plain, {int((nan_k != nan_p).sum())} "
                                     f"differ; finite cells {rel} of the magnitude")
                    inf_worst[tier] = max(inf_worst[tier], rel)
                    if tier != "float32" and err.numel():
                        kernel_err[tier] = max(kernel_err[tier], float(err.max()))
                inf_shapes += 1
    print(f"[kernel] an inf row (row 7, column 3), {inf_shapes} shapes (Q in 7, 2048; N in 128, 20096; D in 24, "
          f"128, 960): f32, bf16x3 and bf16 kernels NaN in the same cells as their plain versions, +inf where they "
          f"are +inf; finite cells within {json.dumps({t: float(f'{v:.3g}') for t, v in inf_worst.items()})} "
          f"of the magnitude (limit 1e-5)", flush=True)


def _edge_sweep_i8(dev, kernel_err):
    """The int8 kernel at the edge shapes of its design, bit-equal
    (torch.equal) to its plain version: Q in {1, 7, 256, 1000, 2048} (one
    partial 64-query tile up to 32 full ones), N in {128, 128*63, 20096}
    (one group; group counts that leave a four-group corpus tile partly
    empty), D in {16, 48, 96, 128, 144, 384, 640, 960, 2048} (one to four
    k-steps in the last slab; one to sixteen 128-k slabs, which take every
    layout of the kernel's plan, printed per D: two consumer warpgroups of
    two groups each with two corpus buffers and with one, of one group
    each, one warpgroup, and K chunks at 2048). Uniform random int8 values, with rows of all -128 and
    all 127 in the queries and in the first and last groups (the largest
    |dot|, D * 2^14; at D = 2048 all values are halved, so that the plain
    version's f32 sums stay exact), non-integer row terms, and x_term = 1e30
    on the 37 trailing rows. Each shape at scale -2 (a power of two: the
    fused multiply-add epilogue) and -0.3 (multiply, then add)."""
    import torch
    from tpu_knn_torch.ops import groupmin as GM

    nmax, qmax = 20096, 2048
    dims = (16, 48, 96, 128, 144, 384, 640, 960, 2048)
    rng = np.random.default_rng(5)
    x_np = rng.integers(-128, 128, size=(nmax, max(dims)), dtype=np.int8)
    q_np = rng.integers(-128, 128, size=(qmax, max(dims)), dtype=np.int8)
    for row, v in ((0, -128), (1, 127), (128 * 63 - 50, -128), (nmax - 50, 127)):
        x_np[row] = v
    for row, v in ((0, -128), (6, 127), (999, -128), (qmax - 1, 127)):
        q_np[row] = v
    xt_all = torch.from_numpy((rng.random(nmax) * 2e6).astype(np.float32)).to(dev)
    qt_all = torch.from_numpy((rng.random(qmax) * 2e6).astype(np.float32)).to(dev)
    shapes = runs = 0
    layouts = set()
    for d in dims:
        plans = {scale: GM.int8_plan(d, scale) for scale in (-2.0, -0.3)}
        p = plans[-2.0]
        layouts.add((p["warpgroups"], p["groups_each"], p["two_buffers"], p["slabs_resident"] < -(-d // 128)))
        print(f"[kernel] int8 plan at D={d} ({-(-d // 128)} slabs): {json.dumps(p)}; at scale -0.3 "
              f"pow2_scale {plans[-0.3]['pow2_scale']}", flush=True)
        _require(p["pow2_scale"] == 1 and plans[-0.3]["pow2_scale"] == 0,
                 lambda: f"int8 plan at D={d}: the scales did not pick the two epilogues: {plans}")
        # the plain version's f32 matmul is exact only while every partial sum
        # stays within 2^24: past D = 1024 the values are halved (-64 .. 63)
        shift = 1 if d > 1024 else 0
        x_all = torch.from_numpy(np.ascontiguousarray(x_np[:, :d] >> shift)).to(dev)
        q_all = torch.from_numpy(np.ascontiguousarray(q_np[:, :d] >> shift)).to(dev)
        for n in (128, 128 * 63, nmax):
            x = x_all[:n]
            xt = xt_all[:n].clone()
            xt[n - 37:] = 1e30
            for nq in (1, 7, 256, 1000, qmax):
                q, qt = q_all[:nq], qt_all[:nq].contiguous()
                for scale in (-2.0, -0.3):
                    out = GM.fused_groupmin(q, x, qt, xt, scale)
                    torch.cuda.synchronize()
                    ref = GM.fused_groupmin_reference(q, x, qt, xt, scale)
                    _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                             lambda: f"int8 at Q={nq} N={n} D={d}: output not finite or not {tuple(ref.shape)}")
                    if not torch.equal(out, ref):
                        bad = (out != ref).nonzero()
                        i, g = (int(v) for v in bad[0])
                        raise RuntimeError(
                            f"int8 kernel differs from its plain version at Q={nq} N={n} D={d} scale {scale}: "
                            f"{bad.shape[0]} of {out.numel()} entries, first at query {i} group {g}: "
                            f"{float(out[i, g])!r} against {float(ref[i, g])!r}")
                    kernel_err["int8"] = max(kernel_err["int8"], float((out - ref).abs().max()))
                    runs += 1
                shapes += 1
    _require(len(layouts) == 5, lambda: f"the int8 sweep took {len(layouts)} layouts of the plan, not 5: {layouts}")
    print(f"[kernel] int8 edge sweep, {shapes} shapes x 2 scales = {runs} runs (Q in 1, 7, 256, 1000, 2048; "
          f"N in 128, 8064, 20096; D in {', '.join(map(str, dims))}), {len(layouts)} layouts: every one "
          f"bit-equal to its plain version", flush=True)


def _median_ms(fn, reps: int = 7):
    """(median, min, max) host ms of ``fn``, which returns host numpy (so it is synchronized)."""
    times = []
    for _ in range(reps):
        ts = time.perf_counter()
        fn()
        times.append((time.perf_counter() - ts) * 1e3)
    return statistics.median(times), min(times), max(times)


def _breakdown(idx, queries, k: int, tier: str = "float32"):
    """Device ms per stage of idx.knn_query_batch(queries, k) on the
    two-pass route (CUDA events, mean of 5), and the query encoding.
    Reduced tiers time pass 1 with its certificate and f32 redo as one
    stage."""
    from tpu_knn_torch.methods import seq_search as SS

    space, data = idx.space, idx.method.data
    qpts, _ = idx._bucket_query_points(queries)
    qenc = space.encode_queries(qpts)
    stages = {"encode_queries": _cuda_ms(lambda: space.encode_queries(qpts), 5)}
    if tier == "float32":
        mins = SS._pass1(space, qenc, data)
        gsel = SS._select_groups(mins, k)
        stages["pass1_groupmin"] = _cuda_ms(lambda: SS._pass1(space, qenc, data), 5)
        stages["select_groups"] = _cuda_ms(lambda: SS._select_groups(mins, k), 5)
    else:
        gsel, _, _ = SS._pass1_certified(space, qenc, data, k, tier)
        stages["pass1_certified_select"] = _cuda_ms(
            lambda: SS._pass1_certified(space, qenc, data, k, tier), 5)
    stages["pass2_gather_rescore"] = _cuda_ms(lambda: SS._pass2(space, qenc, data, gsel, k), 5)
    return stages, qenc


def _groupmin_bound(q, x, qt, xt, scale):
    """Per-(query, group) bound on |f32 kernel - exact| for the group mins
    of scale*<q,x> + x_term + q_term: the f32 dot of depth D is within
    D*u*|q||x| (Higham eq. 3.5 with Cauchy-Schwarz), and the scale, the two
    term additions and their operands' rounding add at most 3*u times the
    magnitude M = |scale||q||x| + |x_term| + |q_term|. Row quantities are
    taken as their max over the group."""
    import torch

    d = q.shape[1]
    qn = q.double().norm(dim=1)[:, None]
    xn = x.double().norm(dim=1).view(-1, 128).amax(1)[None, :]
    xtm = xt.double().abs().view(-1, 128).amax(1)[None, :]
    mag = abs(scale) * qn * xn + xtm + qt.double().abs()[:, None]
    return U * (d * abs(scale) * qn * xn + 3.0 * mag), mag


def _oracle_topk(q, x, k: int, chunk: int = 65536):
    """Exact float64 L2 top-k by a plain chunked product (ascending)."""
    best_d, best_i = _oracle_sq_topk(q, x, k, chunk)
    return best_d.clamp_min(0).sqrt(), best_i


def _oracle_sq_topk(q, x, k: int, chunk: int = 65536):
    """Float64 squared-L2 top-k by a plain chunked product (ascending); exact
    for integer-valued inputs such as uint8 descriptors (every sum < 2^53)."""
    import torch

    q64 = q.double()
    qn = (q64 * q64).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk].double()
        d2 = qn + (xc * xc).sum(1)[None, :] - 2.0 * (q64 @ xc.T)
        dc, ic = torch.topk(d2, min(k, xc.shape[0]), dim=1, largest=False)
        best_d = torch.cat([best_d, dc], 1)
        best_i = torch.cat([best_i, ic + s], 1)
        best_d, sel = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
        best_i = torch.gather(best_i, 1, sel)
    return best_d, best_i


def _same_results(label, d, i, d_ref, i_ref):
    """Distances bit-identical to the reference tier's; ids equal up to the
    order of exactly equal distances (each row holds the same (dist, id) pairs)."""
    _require(np.array_equal(d, d_ref), lambda: (
        f"{label}: distances differ from the f32 tier at {int((d != d_ref).sum())} slots"))
    pairs = np.sort(np.rec.fromarrays([d, i]), axis=1)
    pairs_ref = np.sort(np.rec.fromarrays([d_ref, i_ref]), axis=1)
    _require(np.array_equal(pairs, pairs_ref), lambda: f"{label}: ids differ from the f32 tier")
    print(f"[same] {label}: distances bit-identical to the f32 tier; ids equal at "
          f"{int((i == i_ref).sum())}/{i.size} slots, the rest among exactly equal distances", flush=True)


def _check_against_oracle(label, ids, dists, q, x, k, dot_rel: float = 0.0):
    """Ids must equal the oracle's except on ties. The returned f32
    distances must be within the f32 norm-identity bound
    B = (D+3)*u*(|q|+|x|)^2 of the exact squared distance, so an f32 scan
    cannot order two ids whose exact squared distances differ by less than
    2B: a tie is an exact distance within 1e-5 relative of the oracle's at
    that rank, or a squared distance within 2B of it. ``dot_rel`` widens B
    by 2*dot_rel*|q||x| for a product computed at a reduced tier whose
    error is at most dot_rel*|q||x|."""
    import torch

    dev = q.device
    od, oi = _oracle_topk(q, x, k)
    ids_t = torch.as_tensor(ids, device=dev)
    _require(ids_t.shape == oi.shape and bool((ids_t >= 0).all()), lambda: f"{label}: missing results")
    diff = ids_t != oi
    q64 = q.double()
    xr = x[ids_t].double()  # [Q, k, D] rows of the returned ids
    exact = ((xr - q64[:, None, :]) ** 2).sum(-1)  # f64 squared distances
    qn, xn = q64.norm(dim=1)[:, None], xr.norm(dim=-1)
    bound = (q.shape[1] + 3) * U * (qn + xn) ** 2 + 2.0 * dot_rel * qn * xn
    rel = (exact.sqrt() - od).abs() / od
    f32_tie = (exact - od * od).abs() <= 2.0 * bound
    bad = diff & (rel > 1e-5) & ~f32_tie
    n_rel = int((diff & (rel <= 1e-5)).sum())
    worst = float(((exact - od * od).abs() / (2.0 * bound))[diff].max()) if bool(diff.any()) else 0.0
    _require(not bool(bad.any()), lambda: (
        f"{label}: {int(bad.sum())} ids differ from the f64 oracle beyond ties; first query "
        f"{int(bad.any(1).nonzero()[0])}, worst relative gap {float(rel[bad].max()):.3g}"
    ))
    d_t = torch.as_tensor(dists, device=dev).double()
    d2_err = (d_t * d_t - exact).abs()
    _require(bool((d2_err <= bound).all()), lambda: (
        f"{label}: distance beyond the f32 bound, worst ratio {float((d2_err / bound).max()):.3g}"
    ))
    print(
        f"[oracle] {label}: {q.shape[0]} queries x k={k}: ids equal to the f64 oracle at "
        f"{int((~diff).sum())}/{diff.numel()} slots; of the other {int(diff.sum())}, {n_rel} tie "
        f"within 1e-5 relative and the rest within the f32 bound (worst gap/2B {worst:.3g}); "
        f"max d^2 error/bound {float((d2_err / bound).max()):.3g}",
        flush=True,
    )


def _dot_topk(q, x, k: int, chunk: int = 65536):
    """Float64 top-k of the largest <q, x> by a plain chunked product:
    (dots [Q, k] descending, positions)."""
    import torch

    q64 = q.double()
    best_v = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], chunk):
        g = q64 @ x[s:s + chunk].double().T
        v, i = torch.topk(g, min(k, g.shape[1]), dim=1)
        best_v, sel = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]), dim=1)
        best_i = torch.gather(torch.cat([best_i, i + s], 1), 1, sel)
    return best_v, best_i


def _check_dot_oracle(label, ids, q, x, k: int, dists=None, dot_of=None):
    """Ids of a dot-product space (rows as the index stores them: normalized
    for cosinesimil/angulardist, raw for negdotprod) against a float64
    oracle of <q, x>. An f32 product of depth D is within
    B = (D+2)*u*|q||x| of the exact one, so ids may differ from the
    oracle's only where the two f64 dots lie within 2B. With ``dot_of``
    (returned f64 distances -> the dot they stand for), each must lie
    within B + 16u (the post-transform's rounding) of its id's f64 dot."""
    import torch

    dev = q.device
    ov, oi = _dot_topk(q, x, k)
    ids_t = torch.as_tensor(ids, device=dev).long()
    _require(ids_t.shape == oi.shape and bool((ids_t >= 0).all()), lambda: f"{label}: missing results")
    q64 = q.double()
    xr = x[ids_t].double()
    dot = (xr * q64[:, None, :]).sum(-1)  # f64 <q, x> of the returned ids
    bound = (q.shape[1] + 2) * U * q64.norm(dim=1)[:, None] * xr.norm(dim=-1)
    diff = ids_t != oi
    bad = diff & ((dot - ov).abs() > 2.0 * bound)
    worst = float(((dot - ov).abs() / (2.0 * bound))[diff].max()) if bool(diff.any()) else 0.0
    _require(not bool(bad.any()), lambda: (
        f"{label}: {int(bad.sum())} ids differ from the f64 oracle beyond ties; first query "
        f"{int(bad.any(1).nonzero()[0])}"))
    msg = ""
    if dot_of is not None:
        err = (torch.as_tensor(dot_of(np.asarray(dists, np.float64)), device=dev) - dot).abs()
        ratio = float((err / (bound + 16 * U)).max())
        _require(ratio <= 1.0, lambda: f"{label}: distance beyond the f32 bound, worst ratio {ratio:.3g}")
        msg = f"; max distance error/bound {ratio:.3g}"
    print(f"[oracle] {label}: {q.shape[0]} queries x k={k}: ids equal to the f64 oracle at "
          f"{int((~diff).sum())}/{diff.numel()} slots, the other {int(diff.sum())} within the f32 "
          f"bound of the oracle's dot (worst gap/2B {worst:.3g}){msg}", flush=True)


def _range_check_l2(label, res, q, x, radius: float, chunk: int = 32768):
    """Range results of the l2 space against a float64 oracle. The f32
    distance of a pair is within the norm-identity bound
    B = (D+3)*u*(|q|+|x|)^2 of the exact squared distance, and its sqrt
    and the comparison add at most 4*u*r^2; so a point is certainly in
    when d64^2 < r^2 - band, certainly out when d64^2 > r^2 + band, and
    undecided in between. Every returned id must not be certainly out, and
    each query must return every certainly-in point (returned ids are
    distinct, so the number of returned certainly-in ids must equal the
    oracle's count of them). Returns (certainly-in counts, undecided
    counts) per query."""
    import torch

    dev = q.device
    q64 = q.double()
    qn2 = (q64 * q64).sum(1, keepdim=True)
    qn = qn2.sqrt()
    r2 = float(radius) ** 2
    sure_in = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    undecided = torch.zeros_like(sure_in)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk].double()
        xn2 = (xc * xc).sum(1)[None, :]
        d2 = qn2 + xn2 - 2.0 * (q64 @ xc.T)
        band = (q.shape[1] + 3) * U * (qn + xn2.sqrt()) ** 2 + 4 * U * r2
        sure_in += (d2 < r2 - band).sum(1)
        undecided += ((d2 - r2).abs() <= band).sum(1)
    qi = torch.as_tensor(np.repeat(np.arange(len(res)), [len(r.ids) for r in res]), device=dev)
    ids = torch.as_tensor(np.concatenate([r.ids for r in res]).astype(np.int64), device=dev)
    dists = torch.as_tensor(np.concatenate([r.dists for r in res]), device=dev).double()
    xr = x[ids].double()
    d2 = ((xr - q64[qi]) ** 2).sum(1)
    band = (q.shape[1] + 3) * U * (qn[qi, 0] + xr.norm(dim=1)) ** 2 + 4 * U * r2
    _require(not bool((d2 > r2 + band).any()), lambda: f"{label}: a returned point lies outside the radius")
    got_in = torch.zeros_like(sure_in).index_add_(0, qi, (d2 < r2 - band).long())
    _require(torch.equal(got_in, sure_in), lambda: (
        f"{label}: {int((got_in != sure_in).sum())} queries miss points certainly inside the radius"))
    _require(bool(((dists * dists - d2).abs() <= band).all()), lambda: f"{label}: a distance beyond the f32 bound")
    return sure_in, undecided


def _range_check_common(label, res, radius: float, n_pad: int):
    """Per-query structure of range results: int32 ids, f32 ascending
    distances within the radius, no id twice. Returns the counts."""
    from tpu_knn_torch.methods.base import range_cap

    counts = np.asarray([len(r.ids) for r in res])
    for j, r in enumerate(res):
        _require(r.ids.dtype == np.int32 and r.dists.dtype == np.float32,
                 lambda: f"{label}: query {j} returned {r.ids.dtype} ids, {r.dists.dtype} distances")
        _require(bool((r.dists <= radius).all()) and bool((np.diff(r.dists) >= 0).all()),
                 lambda: f"{label}: query {j} has distances past the radius or out of order")
        _require(len(np.unique(r.ids)) == len(r.ids) and bool((r.ids >= 0).all()),
                 lambda: f"{label}: query {j} returned an id twice or a padding row")
    cap = range_cap(counts.max(), n_pad)
    print(f"[range] {label}: {len(res)} queries at radius {radius!r}: {int(counts.sum())} hits, "
          f"{int((counts >= 10).sum())} queries with 10 or more, largest count {int(counts.max())}, "
          f"cap {cap} of n_pad {n_pad}", flush=True)
    _require(cap <= n_pad // 8, lambda: f"{label}: the cap {cap} is not well below n_pad {n_pad}")
    return counts


def _timed_range(label, idx, queries, radius, smi):
    """Print the median of 5 host ms of range_query_batch, the peak device
    memory of one run, and the device ms of its two passes (CUDA events,
    mean of 3)."""
    import torch
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.methods.base import range_cap

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = idx.range_query_batch(queries, radius)
    peak = torch.cuda.max_memory_allocated()
    med, tmin, tmax = _median_ms(lambda: idx.range_query_batch(queries, radius), 5)
    m = idx.method
    qenc = m.space.encode_queries(queries)
    cap = range_cap(max(len(r.ids) for r in res), m.data.ids.shape[0])
    stages = {
        "counts_pass": _cuda_ms(lambda: SS._range_counts_device(
            m.space, qenc, m.data, radius, m._chunk, m.precision), 3),
        "collect_pass": _cuda_ms(lambda: SS._range_collect_device(
            m.space, qenc, m.data, radius, cap, m._chunk, m.precision), 3),
    }
    print(f"[range] {label} range_query_batch Q={len(queries)}: median {med:.3f} ms of 5 (min {tmin:.3f}, "
          f"max {tmax:.3f}), {len(queries) / med * 1e3:.1f} qps; peak allocated {peak / 2**30:.3f} GiB; "
          f"device ms per pass (chunk {m._chunk}, cap {cap}) "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}; {smi}", flush=True)


def _phase_range(idx, sidx, queries, qu8, corpus, cu8, d10, d8, smi):
    """Range search on phase 4's l2 index and phase 6's l2sqr_sift index."""
    import torch

    dev = torch.device("cuda", 0)
    radius = float(np.median(d10[:, K - 1]))
    res = idx.range_query_batch(queries, radius)
    n_pad = idx.method.data.ids.shape[0]
    counts = _range_check_common(f"l2 {N_CORPUS} rows", res, radius, n_pad)
    x_dev = torch.from_numpy(corpus).to(dev)
    sure_in, undecided = _range_check_l2(f"l2 {N_CORPUS} rows", res, torch.from_numpy(queries).to(dev), x_dev, radius)
    del x_dev
    n_und = int(undecided.sum())
    print(f"[oracle] range l2 {N_CORPUS} rows: every query returned all {int(sure_in.sum())} points certainly inside "
          f"the radius and none certainly outside; {n_und} points lie within the f32 bound of the radius "
          f"and {int(counts.sum() - sure_in.sum())} of them were returned", flush=True)
    _timed_range(f"l2 {N_CORPUS} x {DIM}", idx, queries, radius, smi)

    # l2sqr_sift: exact integer distances against the exact integer oracle
    r8 = float(np.median(d8[:, K - 1]))
    res8 = sidx.range_query_batch(qu8, r8)
    counts8 = _range_check_common(f"l2sqr_sift {N_CORPUS} rows", res8, r8, sidx.method.data.ids.shape[0])
    q8 = torch.from_numpy(qu8).to(dev).double()
    oracle = torch.zeros(len(res8), dtype=torch.int64, device=dev)
    for s in range(0, cu8.shape[0], 65536):
        xc = torch.from_numpy(cu8[s:s + 65536]).to(dev).double()
        d2 = (q8 * q8).sum(1, keepdim=True) + (xc * xc).sum(1)[None, :] - 2.0 * (q8 @ xc.T)
        oracle += (d2 <= r8).sum(1)
    _require(np.array_equal(oracle.cpu().numpy(), counts8), lambda: (
        f"l2sqr_sift range: counts differ from the integer oracle at "
        f"{int((oracle.cpu().numpy() != counts8).sum())} queries"))
    qi = torch.as_tensor(np.repeat(np.arange(len(res8)), counts8), device=dev)
    ids = torch.as_tensor(np.concatenate([r.ids for r in res8]).astype(np.int64), device=dev)
    x8 = torch.from_numpy(cu8).to(dev)
    exact = ((x8[ids].double() - q8[qi]) ** 2).sum(1)
    got = torch.as_tensor(np.concatenate([r.dists for r in res8]), device=dev).double()
    _require(torch.equal(exact, got) and bool((exact <= r8).all()), lambda: (
        "l2sqr_sift range: a returned distance is not its id's exact integer distance within the radius"))
    del x8
    one = sidx.range_query(qu8[0], r8)
    _require(np.array_equal(one.ids, res8[0].ids) and np.array_equal(one.dists, res8[0].dists),
             lambda: "l2sqr_sift range_query of one point differs from its range_query_batch row")
    print(f"[oracle] range l2sqr_sift {N_CORPUS} rows: counts equal to the exact integer oracle for every query, "
          f"every returned distance its id's exact distance, so the id sets are equal; range_query of "
          f"query 0 equal to its batch row", flush=True)
    _timed_range(f"l2sqr_sift {N_CORPUS} x {DIM} uint8", sidx, qu8, r8, smi)


def _phase_persist(idx, queries, d10, i10):
    """Save phase 4's index in both save modes, load it in both load modes,
    and hold knn results to those before the save, bit for bit."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import Index

    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        for save_data in (True, False):
            path = os.path.join(tmp, f"ix_{save_data}")
            ts = time.perf_counter()
            idx.save(path, save_data=save_data)
            save_s = time.perf_counter() - ts
            sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))
                     if f.startswith(f"ix_{save_data}")}
            for load_data in (True, False):
                tl = time.perf_counter()
                back = Index.load(path, load_data=load_data, device="cuda")
                torch.cuda.synchronize()
                load_s = time.perf_counter() - tl
                d, i = back.knn_query_batch(queries, K)
                _require(np.array_equal(d, d10) and np.array_equal(i, i10), lambda: (
                    f"persist save_data={save_data} load_data={load_data}: results differ from before "
                    f"the save at {int((i != i10).sum())} ids, {int((d != d10).sum())} distances"))
                _require(back.method.data.vecs.device.type == "cuda", lambda: "loaded index is not on the card")
                da, ia = back.knn_query_batch_async(queries, K).result()
                _require(np.array_equal(da, d10) and np.array_equal(ia, i10),
                         lambda: "knn_query_batch_async differs from knn_query_batch")
                print(f"[persist] save_data={save_data} load_data={load_data}: save {save_s:.3f} s, "
                      f"load (read + rebuild on the card) {load_s:.3f} s, file bytes {sizes}; knn_query_batch "
                      f"and knn_query_batch_async k={K} bit-identical to before the save", flush=True)
                del back
                torch.cuda.empty_cache()
            for f in list(sizes):
                os.remove(os.path.join(tmp, f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: (ms, ms over the f32 kernel's 13.294 ms) of each wgmma tier's kernel
#: before the wgmma design (the mma.sync kernels), at the 1M shapes
OLD_RATIO = {"high": (6.669, 0.502), "bfloat16": (3.514, 0.264), "int8": (1.868, 0.141)}

N_ANGULAR = 1_183_514  # glove-100-angular's corpus (ann-benchmarks)
DIM_ANGULAR = 100


def _phase_angular(smi):
    """The scalar-product spaces at the glove-100-angular shape, the gold
    standard over that corpus and the metrics of the "high" tier."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval import GoldStandard, per_query_metrics, summarize
    from tpu_knn_torch.eval.datasets import clustered
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import ensure_cert_metadata

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    xall = clustered(N_ANGULAR + N_QUERIES, DIM_ANGULAR, seed=1)
    corpus, queries = xall[:N_ANGULAR], xall[N_ANGULAR:]
    print(f"[angular] data clustered({N_ANGULAR + N_QUERIES}, {DIM_ANGULAR}, seed=1) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    aidx = Index("angulardist", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    tb = time.perf_counter()
    aidx.add_dense_batch(corpus)
    aidx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    da, ia = aidx.knn_query_batch(queries, K)
    launches = dict(GM.launches)
    route = aidx.method.last_route
    print(f"[angular] build {build_s:.3f} s for {N_ANGULAR} x {DIM_ANGULAR} (normalized, padded to "
          f"{aidx.method.data.vecs.shape[1]} columns); first query: route {route}, launches {launches}; "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    _require(route == "twopass" and launches["float32"] > 0,
             lambda: f"the angular path took the {route} route with launches {launches}")
    _require(np.isfinite(da).all() and (np.diff(da, axis=1) >= 0).all() and (da >= 0).all()
             and (da <= np.pi).all(), lambda: "angular distances not finite, ascending and in [0, pi]")
    med, tmin, tmax = _median_ms(lambda: aidx.knn_query_batch(queries, K))
    print(f"[angular] knn_query_batch Q={N_QUERIES} k={K} over {N_ANGULAR} x {DIM_ANGULAR}: median "
          f"{med:.3f} ms of 7 (min {tmin:.3f}, max {tmax:.3f}), {N_QUERIES / med * 1e3:.1f} qps on {smi}",
          flush=True)
    stages, qenc = _breakdown(aidx, queries, K)
    print("[angular breakdown] device ms per stage: "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}), flush=True)

    # the f32 and bf16x3 kernels at these shapes: scale -1, zero q_term, x_term = padding only
    data = aidx.method.data
    qk, qtk, xtk, scale = SS._kernel_inputs(aidx.space, qenc, data)
    _require(scale == -1.0 and xtk is data.extra["pad"] and not bool(qtk.any()),
             lambda: "angular kernel inputs are not (scale -1, q_term 0, x_term pad)")
    ensure_cert_metadata(data)
    f32 = None
    for tier in ("float32", "high", "bfloat16"):
        out = GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale, precision=tier)
        ref = GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale, precision=tier)
        bound, mag = _groupmin_bound(qk, data.vecs, qtk, xtk, scale)
        # pad groups hold 1e30: compare the real groups
        real = data.count // 128
        diff = (out.double() - ref.double()).abs()[:, :real]
        rel = float((diff / mag[:, :real]).max())
        lim = float((diff / (2 * bound[:, :real])).max()) if tier == "float32" else rel / 1e-5
        eps_msg = ""
        if tier == "float32":
            f32 = out
        else:
            eps = SS._pass1_eps(qk, data, scale, tier).double()
            ratio = float(((out.double() - f32.double()).abs()[:, :real].amax(dim=1) / eps).max())
            _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at the angular shapes: {ratio}")
            eps_msg = f"; max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g}"
        ms = _cuda_ms(lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale, precision=tier), 10)
        plain_ms = _cuda_ms(lambda: GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale,
                                                                precision=tier), 3)
        bms, by = _bound_ms(tier, qk, data.vecs)
        print(f"[kernel] {tier} at the angular shapes Q={qk.shape[0]} N={data.vecs.shape[0]} "
              f"D={data.vecs.shape[1]}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; max |kernel - plain| "
              f"{float(diff.max()):.4g} ({rel:.3g} of the magnitude), {lim:.3g} of the limit "
              f"({'2x the f32 bound' if tier == 'float32' else '1e-5 of the magnitude'}){eps_msg}; bound "
              f"{bms:.3f} ms ({by}), {bms / ms:.1%} of it; {smi}", flush=True)
        _require(lim <= 1.0 and bool(torch.isfinite(out).all()),
                 lambda: f"{tier} kernel vs plain at the angular shapes: {lim} of the limit")
    del out, ref, bound, mag, diff, f32

    # float64 oracle on the cosines of the normalized rows the index stores
    x_dev = data.vecs[:data.count]
    q_dev = qenc["q"][:N_QUERIES]
    # arccos has unbounded slope at 1: hold cos(angle), not the angle, to the oracle
    _check_dot_oracle("angulardist k=10", ia, q_dev, x_dev, K, da, np.cos)
    torch.cuda.reset_peak_memory_stats()
    da100, ia100 = aidx.knn_query_batch(queries, 100)
    print(f"[memory] angular peak allocated during the k=100 query "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    _check_dot_oracle("angulardist k=100", ia100, q_dev, x_dev, 100)
    del da100, ia100

    # the gold standard over the same corpus and space, and its cache
    import os
    import tempfile

    gold = GoldStandard(aidx.space, aidx.store)
    gd, gi = gold.compute_knn(queries, K)
    _require(np.array_equal(gd, da) and np.array_equal(gi, ia),
             lambda: "GoldStandard.compute_knn differs from the index's results")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gold_") as tmp:
        gold.save_cache(os.path.join(tmp, "gold"))
        cd, ci = GoldStandard.load_cache(os.path.join(tmp, "gold"))
    _require(np.array_equal(cd, gd) and np.array_equal(ci, gi) and cd.dtype == gd.dtype
             and ci.dtype == gi.dtype, lambda: "gold-standard cache round trip is not exact")
    print(f"[gold] GoldStandard.compute_knn(queries, {K}) equal to the index's results; cache round "
          f"trip exact", flush=True)
    del gold

    # pass1Precision "high" on the same index: bit-identical to the f32 tier
    aidx.build_index(Params(pass1Precision="high"))
    GM.reset_launches()
    dh, ih = aidx.knn_query_batch(queries, K)
    lh = dict(GM.launches)
    m = aidx.method
    print(f"[angular high] route {m.last_route}, launches {lh}, certified {m.last_certified:.6f}, "
          f"redone blocks {m.last_redone_blocks} of {-(-N_QUERIES // SS._CERT_QBLK)}", flush=True)
    _require(m.last_route == "twopass" and lh["high"] > 0,
             lambda: f"the angular high path took the {m.last_route} route with launches {lh}")
    _same_results(f"angular high k={K}", dh, ih, da, ia)
    medh, tminh, tmaxh = _median_ms(lambda: aidx.knn_query_batch(queries, K))
    print(f"[angular high] knn_query_batch Q={N_QUERIES} k={K}: median {medh:.3f} ms of 7 (min "
          f"{tminh:.3f}, max {tmaxh:.3f}); f32 tier {med:.3f} ms; {smi}", flush=True)
    summ = summarize(per_query_metrics(gd, gi, dh, ih))
    print(f"[metrics] high tier against the gold standard: {json.dumps(summ)}", flush=True)
    _require(summ["recall"] == 1.0 and summ["number_closer"] == 0.0,
             lambda: f"high tier metrics against the gold standard: {summ}")
    del aidx, m, data, qenc, qk, qtk, xtk, x_dev, q_dev
    torch.cuda.empty_cache()

    # cosinesimil on the same data: the same ids as angulardist, 1 - cos distances
    cidx = Index("cosinesimil", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    cidx.add_dense_batch(corpus)
    GM.reset_launches()
    dc, ic = cidx.knn_query_batch(queries, K)
    _require(cidx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"cosinesimil took the {cidx.method.last_route} route, launches {GM.launches}")
    cdata = cidx.method.data
    cq = cidx.space.encode_queries(queries)["q"]
    _check_dot_oracle("cosinesimil k=10", ic, cq, cdata.vecs[:cdata.count], K, dc, lambda d: 1.0 - d)
    same = ic == ia
    xo = cdata.vecs[torch.as_tensor(np.where(same, ic, ia), device=dev).long()].double()
    xc = cdata.vecs[torch.as_tensor(ic, device=dev).long()].double()
    gap = ((xo - xc) * cq.double()[:, None, :]).sum(-1).abs().cpu().numpy()
    tie = 2 * (DIM + 2) * U * 1.01
    _require(bool((same | (gap <= tie)).all()), lambda: "cosinesimil ids differ from angulardist's beyond ties")
    print(f"[cosine] cosinesimil k={K}: ids equal to angulardist's at {int(same.sum())}/{same.size} slots, "
          f"the rest within the f32 bound of each other's cosine", flush=True)
    del cidx, cdata, cq, xo, xc
    torch.cuda.empty_cache()

    # negdotprod on the raw rows
    nidx = Index("negdotprod", Params(dim=DIM_ANGULAR), method="seq_search", device="cuda")
    nidx.add_dense_batch(corpus)
    GM.reset_launches()
    dn, in_ = nidx.knn_query_batch(queries, K)
    _require(nidx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"negdotprod took the {nidx.method.last_route} route, launches {GM.launches}")
    ndata = nidx.method.data
    nq = nidx.space.encode_queries(queries)["q"]
    _check_dot_oracle("negdotprod k=10", in_, nq, ndata.vecs[:ndata.count], K, dn, np.negative)
    del nidx, ndata, nq
    torch.cuda.empty_cache()


def _phase_precision(corpus, queries, smi):
    """``precision`` of the single-pass scan (space.block's matmul tier)
    on phase 5's 3000-row index."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval import per_query_metrics, summarize

    dev = torch.device("cuda", 0)
    q_dev, x_dev = torch.from_numpy(queries).to(dev), torch.from_numpy(corpus[:3000]).to(dev)
    out = {}
    for precision in ("float32", "high", "bfloat16"):
        pidx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        pidx.add_dense_batch(corpus[:3000])
        pidx.build_index(Params(precision=precision))
        out[precision] = pidx.knn_query_batch(queries, K)
        _require(pidx.method.last_route == "single", lambda: f"precision {precision}: not the single-pass route")
    # bf16x3 drops lo.lo and the second-level residuals: at most 3 * 2^-18 of
    # |q||x| (with headroom), plus the f32 sums of its three products
    high_rel = 3 * 2.0**-18 * 1.02 + 2 * (DIM + 2) * U
    _check_against_oracle("precision high, single pass, 3000 rows", out["high"][1], out["high"][0],
                          q_dev, x_dev, K, dot_rel=high_rel)
    gd, gi = out["float32"]
    bd, bi = out["bfloat16"]
    summ = summarize(per_query_metrics(gd, gi, bd, bi, check_invariant=False))
    print(f"[precision] bfloat16, single pass, 3000 rows, k={K}: against the f32 gold "
          f"{json.dumps(summ)} (approximate by design; distances at the bf16 tier)", flush=True)
    _require(summ["recall"] > 0.0, lambda: f"bfloat16 recall {summ['recall']}")


def _phase_nan(smi):
    """A corpus row that holds +inf, 20,000 x 16 rows, row 7 column 3, k=5,
    through Index(device="cuda") on the two-pass route. On the CPU both
    packages return that row first with distance NaN for a query whose norm
    identity gives inf - inf (the plain pass 1 carries the NaN into the
    group's min, and smallest_k ranks NaN first). The kernels' min carries
    NaN too (csrc/min_nan.cuh): the f32 kernel's group mins equal its plain
    version's, with NaN in the same cells, and every such query returns row
    7 first through Index(device="cuda"), as on the CPU."""
    import torch
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.ops import groupmin as GM

    rng = np.random.default_rng(0)
    x = rng.standard_normal((20_000, 16)).astype(np.float32)
    x[7, 3] = np.inf
    q = rng.standard_normal((64, 16)).astype(np.float32)
    idx = Index("l2", Params(dim=16), method="seq_search", device="cuda")
    idx.add_dense_batch(x)
    GM.reset_launches()
    d, i = idx.knn_query_batch(q, 5)
    _require(idx.method.last_route == "twopass" and GM.launches["float32"] > 0,
             lambda: f"NaN input: route {idx.method.last_route}, launches {dict(GM.launches)}")
    data = idx.method.data
    qe = idx.space.encode_queries(q)
    xt = (data.extra["pad"] + data.row_term).contiguous()
    k_out = GM.fused_groupmin(qe["q"], data.vecs, qe["q_term"].contiguous(), xt, -2.0)
    p_out = GM.fused_groupmin_reference(qe["q"], data.vecs, qe["q_term"].contiguous(), xt, -2.0)
    # queries with q[3] > 0 give |x|^2 - 2 q.x = inf - inf at row 7; the others give +inf there
    want = q[:, 3] > 0
    kn, pn = torch.isnan(k_out[:, 0]).cpu().numpy(), torch.isnan(p_out[:, 0]).cpu().numpy()
    first_nan = np.isnan(d[:, 0]) & (i[:, 0] == 7)
    others = ~torch.isnan(p_out)
    _require(torch.equal(torch.isnan(k_out), torch.isnan(p_out)),
             lambda: f"NaN input: the kernel's mins are NaN in {int(torch.isnan(k_out).sum())} cells, the plain "
                     f"version's in {int(torch.isnan(p_out).sum())}, {int((torch.isnan(k_out) != torch.isnan(p_out)).sum())} differ")
    _require(torch.equal(k_out[others], p_out[others]) or
             bool(((k_out[others] - p_out[others]).abs() <= 1e-4 * p_out[others].abs()).all()),
             lambda: "NaN input: kernel and plain differ beyond rounding where neither is NaN")
    _require(not np.isnan(d[:, 1:]).any() and (np.isnan(d[:, 0]) == first_nan).all(),
             lambda: "NaN input: a NaN distance that is not row 7 in first place")
    _require(np.array_equal(first_nan, want) and np.array_equal(pn, want),
             lambda: f"NaN input: {int(first_nan.sum())} of the {int(want.sum())} NaN queries return row 7 first")
    print(f"[nan] row 7 holds +inf, 20,000 x 16, k=5, two-pass on the card: {int(want.sum())} of 64 queries "
          f"have inf - inf there; group 0's min is NaN for {int(pn.sum())} of them in the plain version "
          f"(torch.min) and for {int(kn.sum())} in the f32 kernel (min.NaN.f32), NaN in the same cells; "
          f"knn_query_batch returns row 7 first with distance NaN for {int(first_nan.sum())} queries "
          f"(the CPU path and tpu_knn: all {int(want.sum())}); {smi}", flush=True)
    return {"queries": int(want.sum()), "plain_nan": int(pn.sum()), "kernel_nan": int(kn.sum()),
            "returned_nan_first": int(first_nan.sum())}


def _recall_at(ids, gold, k: int) -> float:
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, gold)]))


def _check_exact_distances(label, d, ids, q_dev, x_dev):
    """Every returned distance against the float64 distance of that id
    (rtol 5e-3, atol 1e-5: the l2 norm-identity floor)."""
    import torch

    pos = torch.from_numpy(ids.astype(np.int64)).to(x_dev.device)
    _require(bool((pos >= 0).all()), lambda: f"{label}: an id of -1")
    ref = (x_dev[pos].double() - q_dev.double()[:, None, :]).norm(dim=2).cpu().numpy()
    bad = np.abs(d - ref) > 1e-5 + 5e-3 * np.abs(ref)
    _require(not bad.any(), lambda: f"{label}: {int(bad.sum())} distances off their f64 value, worst "
                                    f"{float(np.abs(d - ref).max())}")
    return float(np.abs(d - ref).max())


def _phase_hnsw(smi):
    """The default method at the repo's own HNSW cell (100,000 x 128
    sift_like rows, M=16, efConstruction=200, waveSize=1024; 2048 queries,
    k=10): build, check_graph, recall and qps against GoldStandard over
    efSearch, exact distances, range raises, save and load on the card, the
    replicated neighbour stores, determinism at 20,000 rows, and l2sqr_sift
    and angulardist at 20,000 rows. Returns the numbers it printed."""
    import os
    import shutil
    import tempfile

    import torch
    from tpu_knn_torch import DataKind, DistKind, Index, Params
    from tpu_knn_torch.core.errors import SpaceIncompatibleError
    from tpu_knn_torch.eval import GoldStandard
    from tpu_knn_torch.eval.datasets import clustered, sift_like
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.ops import groupmin as GM

    n, nq, k = 100_000, N_QUERIES, K
    xall = sift_like(n + nq, DIM, seed=0)
    corpus, queries = xall[:n], xall[n:]
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    out = {}

    idx = Index("l2", Params(dim=DIM), device="cuda")  # no method=: the default
    _require(idx.get_method() == "hnsw", lambda: f"the default method is {idx.get_method()!r}")
    idx.add_dense_batch(corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.reset_counters()
    tb = time.perf_counter()
    idx.build_index(Params(M=16, efConstruction=200, waveSize=1024))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    m = idx.method
    chk = m.check_graph()
    deg = m.degree_distribution()
    out.update(build_s=build_s, build_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[hnsw] build {n} x {DIM}, M=16 efConstruction=200 waveSize=1024 (buildAlgo auto -> waves, "
          f"construction store {bool(m.construction_store) and m._cstore_ok()}): {build_s:.2f} s, peak allocated "
          f"{out['build_peak_gib']:.3f} GiB, {len(m._upper) + 1} levels, mean level-0 degree "
          f"{float(np.average(np.arange(deg.shape[0]), weights=deg)):.2f}, check_graph {chk}, beam iterations "
          f"{G.counters['beam_iters']} with {G.counters['beam_syncs']} syncs; {smi}", flush=True)
    _require(chk == zero, lambda: f"check_graph after the 100k build: {chk}")
    _require(m.data.vecs.device.type == "cuda" and m.graph["level0"].device.type == "cuda",
             lambda: "the built index is not on the card")
    _require(m._qenc_all is None, lambda: "construction state kept after the build")

    GM.reset_launches()
    gold = GoldStandard(idx.space, idx.store)
    gd, gi = gold.compute_knn(queries, k)
    _require(GM.launches["float32"] > 0 and gold.method.last_route == "twopass",
             lambda: f"the gold standard did not run the f32 kernel: {dict(GM.launches)}")
    q_dev = torch.from_numpy(queries).to("cuda")
    x_dev = torch.from_numpy(corpus).to("cuda")

    def sweep(label, index, efs):
        rows = {}
        for ef in efs:
            index.set_query_time_params(Params(efSearch=ef))
            torch.cuda.reset_peak_memory_stats()
            d, i = index.knn_query_batch(queries, k)  # warm
            peak = torch.cuda.max_memory_allocated() / 2**30
            G.reset_counters()
            index.knn_query_batch(queries, k)
            counts = dict(G.counters)
            best = _median_ms(lambda: index.knn_query_batch(queries, k), reps=3)[1]
            _require(d.shape == (nq, k) and i.shape == (nq, k) and np.isfinite(d).all()
                     and (np.diff(d, axis=1) >= 0).all(), lambda: f"{label} efSearch={ef}: bad result")
            err = _check_exact_distances(f"{label} efSearch={ef}", d, i, q_dev, x_dev)
            rows[ef] = dict(recall=_recall_at(i, gi, k), ms=best, qps=nq / best * 1e3, d=d, i=i)
            print(f"[hnsw] {label} efSearch={ef}: recall@{k} {rows[ef]['recall']:.4f}, best of 3 {best:.2f} ms, "
                  f"{rows[ef]['qps']:.0f} qps, peak {peak:.3f} GiB; beam iterations {counts['beam_iters']} with "
                  f"{counts['beam_syncs']} syncs, descent steps {counts['descent_steps']} with "
                  f"{counts['descent_syncs']} syncs; max |d - f64| {err:.3g}; {smi}", flush=True)
        return rows

    plain = sweep("l2", idx, (10, 14, 20, 50, 100, 200))
    _require(plain[20]["recall"] >= 0.95 and plain[100]["recall"] >= 0.99,
             lambda: f"recall@10 {plain[20]['recall']} at efSearch=20, {plain[100]['recall']} at 100")
    dup = [int((np.sort(r["i"], axis=1)[:, 1:] == np.sort(r["i"], axis=1)[:, :-1]).sum()) for r in plain.values()]
    _require(sum(dup) == 0, lambda: f"duplicate ids in results: {dup}")
    out["search"] = {ef: {a: r[a] for a in ("recall", "ms", "qps")} for ef, r in plain.items()}

    try:
        idx.range_query(queries[0], 1.0)
        raised = False
    except SpaceIncompatibleError:
        raised = True
    _require(raised, lambda: "range_query on hnsw did not raise SpaceIncompatibleError")

    # save -> load on the card -> identical answers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hnsw_")
    try:
        path = os.path.join(tmp, "hnsw")
        ts = time.perf_counter()
        idx.save(path)
        save_s = time.perf_counter() - ts
        tl = time.perf_counter()
        back = Index.load(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - tl
        back.set_query_time_params(Params(efSearch=50))
        db, ib = back.knn_query_batch(queries, k)
        _require(np.array_equal(db, plain[50]["d"]) and np.array_equal(ib, plain[50]["i"]),
                 lambda: "results after save and load differ")
        _require(back.get_method() == "hnsw" and back.method.graph["level0"].device.type == "cuda"
                 and torch.equal(back.method.graph["level0"], m.graph["level0"]),
                 lambda: "the loaded graph differs or is not on the card")
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        print(f"[hnsw] save {save_s:.3f} s, Index.load(device='cuda') {load_s:.3f} s, files {sizes}: ids and "
              f"distances at efSearch=50 identical to before the save", flush=True)
        out.update(save_s=save_s, load_s=load_s)
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # replicateNeighbors=1 at the 100k cell: the store is made lazily from the
    # graph at the first query, so this sets the built method's two parameters
    # instead of building the same graph twice more; the parameters' own way
    # in, through build_index, runs below at 20,000 rows
    base_mem = idx.memory_usage_bytes()
    for dtype in ("bfloat16", "int8"):
        m.replicate_neighbors, m.nbr_store_dtype, m._nbr_store = 1, dtype, None
        torch.cuda.reset_peak_memory_stats()
        rep = sweep(f"replicateNeighbors=1 {dtype}", idx, (20, 100))
        store = m._nbr_store[1]
        grown = idx.memory_usage_bytes() - base_mem
        _require(grown == store.nbytes and tuple(store.shape) == (m.data.ids.shape[0], 32, DIM),
                 lambda: f"memory_usage_bytes grew by {grown}, the store holds {store.nbytes}")
        for ef in (20, 100):
            _require(abs(rep[ef]["recall"] - plain[ef]["recall"]) <= 0.01,
                     lambda: f"{dtype} store recall {rep[ef]['recall']} against {plain[ef]['recall']} at {ef}")
        print(f"[hnsw] {dtype} store {store.nbytes / 2**30:.3f} GiB, counted by memory_usage_bytes "
              f"({base_mem / 2**30:.3f} -> {(base_mem + grown) / 2**30:.3f} GiB), peak while it was made and "
              f"searched {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
        out[f"store_{dtype}"] = {ef: {a: r[a] for a in ("recall", "ms", "qps")} for ef, r in rep.items()}
    m.replicate_neighbors, m._nbr_store = 0, None
    del idx, m, gold, x_dev
    torch.cuda.empty_cache()

    # determinism at 20,000 x 128: same seed, same graph, on the card
    n2 = 20_000
    det_params = dict(M=8, efConstruction=60, waveSize=256, seed=11)

    def det_build(**kw):
        ix = Index("l2", Params(dim=DIM), device="cuda")
        ix.add_dense_batch(corpus[:n2])
        t0 = time.perf_counter()
        ix.build_index(Params(det_params, **kw))
        torch.cuda.synchronize()
        return ix, time.perf_counter() - t0

    (a, sa), (b, sb) = det_build(), det_build()
    same = torch.equal(a.method.graph["level0"], b.method.graph["level0"]) and len(a.method._upper) > 0 and all(
        torch.equal(ua, ub) for ua, ub in zip(a.method._upper, b.method._upper))
    _require(same, lambda: "two builds from one seed gave different graphs")
    qa = corpus[:64]
    (da, ia), (db, ib) = a.knn_query_batch(qa, 5), b.knn_query_batch(qa, 5)
    _require(np.array_equal(da, db) and np.array_equal(ia, ib), lambda: "identical graphs answer differently")
    qo = corpus[10:42].copy()
    _, fwd = a.knn_query_batch(qo, 5)
    _, rev = a.knn_query_batch(qo[::-1].copy(), 5)
    _require(np.array_equal(fwd, rev[::-1]), lambda: "a query's result depends on its place in the batch")
    p, sp = det_build(post=1)
    chk = p.method.check_graph()
    _require(chk == zero and a.method.check_graph() == zero, lambda: f"check_graph with post=1: {chk}")
    # replicateNeighbors and nbrStoreDtype as build_index parameters: the same
    # graph, answers through the store within 0.01 recall of the plain ones
    qd = queries[:256]
    _, g2 = GoldStandard(a.space, a.store).compute_knn(qd, k)
    q2_dev, x2_dev = torch.from_numpy(qd).to("cuda"), torch.from_numpy(corpus[:n2]).to("cuda")
    a.set_query_time_params(Params(efSearch=100))
    rec_plain = _recall_at(a.knn_query_batch(qd, k)[1], g2, k)
    for dtype in ("bfloat16", "int8"):
        r, _ = det_build(replicateNeighbors=1, nbrStoreDtype=dtype)
        _require(torch.equal(r.method.graph["level0"], a.method.graph["level0"]),
                 lambda: f"replicateNeighbors=1 {dtype}: a different graph")
        before = r.memory_usage_bytes()
        r.set_query_time_params(Params(efSearch=100))
        dr, ir = r.knn_query_batch(qd, k)
        store = r.method._nbr_store[1]
        want = torch.int8 if dtype == "int8" else torch.bfloat16
        _require(store.dtype == want and r.memory_usage_bytes() - before == store.nbytes,
                 lambda: f"build_index(replicateNeighbors=1, nbrStoreDtype={dtype!r}): store {store.dtype}, "
                         f"memory grew by {r.memory_usage_bytes() - before} of {store.nbytes}")
        _check_exact_distances(f"replicateNeighbors=1 {dtype} through build_index", dr, ir, q2_dev, x2_dev)
        rec = _recall_at(ir, g2, k)
        _require(abs(rec - rec_plain) <= 0.01, lambda: f"{dtype} store recall {rec} against {rec_plain}")
        print(f"[hnsw] build_index(Params(replicateNeighbors=1, nbrStoreDtype={dtype!r})), {n2} x {DIM}: the same "
              f"graph, store {store.nbytes / 2**20:.1f} MiB {store.dtype}, recall@{k} at efSearch=100 {rec:.4f} "
              f"(plain {rec_plain:.4f}), distances exact; {smi}", flush=True)
        del r, store
    del q2_dev, x2_dev
    print(f"[hnsw] determinism, {n2} x {DIM}, {det_params}: two builds ({sa:.2f} s, {sb:.2f} s) give equal "
          f"level0 and {len(a.method._upper)} upper levels and identical results; a reversed batch gives the "
          f"reversed results; post=1 builds in {sp:.2f} s with check_graph {chk}; {smi}", flush=True)
    del a, b, p

    # the other dense spaces over 20,000 rows; waveSize=1024 > n/64, so the head of the schedule ramps
    small = Params(M=16, efConstruction=100, waveSize=1024)
    cu8 = np.rint(corpus[:n2]).astype(np.uint8)
    ang = clustered(n2 + 256, 100, seed=1)
    cases = (
        ("l2sqr_sift", dict(data_type=DataKind.UINT8, dist_type=DistKind.INT), None, cu8,
         np.rint(queries[:256]).astype(np.uint8)),
        ("angulardist", {}, Params(dim=100), ang[:n2], ang[n2:]),
    )
    for name, kw, sparams, xs, qs in cases:
        ix = Index(name, sparams, device="cuda", **kw)
        add = ix.add_uint8_batch if name == "l2sqr_sift" else ix.add_dense_batch
        add(xs)
        t0 = time.perf_counter()
        ix.build_index(small)
        torch.cuda.synchronize()
        bs = time.perf_counter() - t0
        ix.set_query_time_params(Params(efSearch=100))
        chk = ix.method.check_graph()
        ds, is_ = ix.knn_query_batch(xs[:256], k)
        self_first = float(np.mean(is_[:, 0] == np.arange(256)))
        _, g_i = GoldStandard(ix.space, ix.store).compute_knn(qs, k)
        rec = _recall_at(ix.knn_query_batch(qs, k)[1], g_i, k)
        print(f"[hnsw] {name} {n2} rows, {small.as_dict()}: build {bs:.2f} s, check_graph {chk}, stores "
              f"eligible {ix.method._cstore_ok()}, self-query first {self_first:.4f} (largest self distance "
              f"{float(ds[:, 0].max()):.3g}), recall@{k} at efSearch=100 {rec:.4f}; {smi}", flush=True)
        _require(chk == zero and self_first == 1.0 and rec >= 0.9,
                 lambda: f"{name}: check_graph {chk}, self-query first {self_first}, recall {rec}")
        if name == "l2sqr_sift":
            _require(bool((ds[:, 0] == 0).all()) and bool((ds == np.rint(ds)).all()),
                     lambda: "l2sqr_sift: a self distance that is not exactly 0, or a non-integer distance")
        out[name] = dict(build_s=bs, recall=rec)
        del ix
    torch.cuda.empty_cache()
    return out


def _phase_nnd(smi, corpus, queries, i10):
    """The default index at SIFT-1M, built by NN-descent (bench.py's
    Params1M, buildAlgo auto), and the 20,000-row side cells. Returns the
    numbers it printed."""
    import torch
    from tpu_knn_torch import DataKind, DistKind, Index, Params
    from tpu_knn_torch.eval import GoldStandard
    from tpu_knn_torch.eval.datasets import clustered, sift_like
    from tpu_knn_torch.ops import graph as G
    from tpu_knn_torch.ops import nndescent as TN
    from tpu_knn_torch.tools.hnsw_profile import nnd_log_summary
    from tpu_knn_torch.utils import logging as L

    n, nq, k = corpus.shape[0], queries.shape[0], K
    zero = {"self_links": 0, "dup_links": 0, "oob_links": 0}
    lines: list = []
    L.LOGGER.set_custom(lambda level, msg: lines.append(msg))
    try:
        idx = Index("l2", Params(dim=DIM), device="cuda")  # the default method
        idx.add_dense_batch(corpus)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        G.reset_counters()
        params1m = dict(M=16, efConstruction=100, waveSize=1024, replicateNeighbors=1, nbrStoreDtype="int8")
        tb = time.perf_counter()
        idx.build_index(Params(params1m, nndProfile=1))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
    finally:
        L.LOGGER.set_stderr()
    m = idx.method
    peak = torch.cuda.max_memory_allocated() / 2**30
    phases, sweeps, repaired = nnd_log_summary(lines)
    chk = m.check_graph()
    unreached = int((~TN._reach_from_host(m.graph["level0"].cpu().numpy(), m._entry)[:n]).sum())
    print(f"[nnd] build {n} x {DIM}, bench.py's Params1M {params1m} (buildAlgo auto -> "
          f"{m._resolve_build_algo(n)}) with nndProfile=1: {build_s:.2f} s, peak allocated {peak:.3f} GiB, "
          f"{len(m._upper) + 1} levels, check_graph {chk}, {unreached} nodes unreached from the entry; phase walls "
          f"(s, a device sync at each) {json.dumps(phases)}; descent updates per sweep {sweeps}; repaired nodes per "
          f"link {repaired}; beam iterations {G.counters['beam_iters']}, descent steps "
          f"{G.counters['descent_steps']}; {smi}", flush=True)
    _require(m._resolve_build_algo(n) == "nndescent" and len(phases) >= 10 and sweeps,
             lambda: f"the 1M default build did not run NN-descent: phases {phases}")
    _require(chk == zero and unreached == 0, lambda: f"1M NN-descent graph: check_graph {chk}, unreached {unreached}")
    _require(m.graph["level0"].device.type == "cuda" and m._qenc_all is None,
             lambda: "the 1M graph is not on the card, or construction state was kept")

    q_dev = torch.from_numpy(queries).to("cuda")
    x_dev = torch.from_numpy(corpus).to("cuda")
    rows = {}
    for ef in (10, 11, 12, 13, 14, 20, 50):  # bench.py's efSearch set at 1M
        idx.set_query_time_params(Params(efSearch=ef))
        d, i = idx.knn_query_batch(queries, k)  # warm; the int8 neighbour store is made at the first
        G.reset_counters()
        idx.knn_query_batch(queries, k)
        counts = dict(G.counters)
        best = _median_ms(lambda: idx.knn_query_batch(queries, k), reps=3)[1]
        _require(d.shape == (nq, k) and np.isfinite(d).all() and (np.diff(d, axis=1) >= 0).all(),
                 lambda: f"1M NN-descent efSearch={ef}: bad result")
        err = _check_exact_distances(f"1M NN-descent efSearch={ef}", d, i, q_dev, x_dev)
        rows[ef] = dict(recall=_recall_at(i, i10, k), ms=best, qps=nq / best * 1e3)
        print(f"[nnd] 1M efSearch={ef}: recall@{k} {rows[ef]['recall']:.4f} (against phase 4's exact ids), best of 3 "
              f"{best:.2f} ms, {rows[ef]['qps']:.0f} qps; beam iterations {counts['beam_iters']}, descent steps "
              f"{counts['descent_steps']}; max |d - f64| {err:.3g}; {smi}", flush=True)
    _require(rows[20]["recall"] >= 0.95, lambda: f"1M NN-descent recall@10 {rows[20]['recall']} at efSearch=20")
    out = {"build_s": build_s, "peak_gib": peak, "phases": phases, "sweeps": sweeps, "repaired": repaired,
           "unreached": unreached, "search": rows}
    del idx, m, x_dev, q_dev
    torch.cuda.empty_cache()

    # side cells at 20,000 rows, buildAlgo="nndescent" below the threshold
    n2 = 20_000
    side = dict(M=16, efConstruction=100, buildAlgo="nndescent")
    cu8 = np.rint(corpus[:n2]).astype(np.uint8)
    ang = clustered(n2 + 256, 100, seed=1)
    wide = sift_like(n2 + 256, 960, seed=3)
    cells = (  # label, space, index kwargs, space params, corpus, queries, build params, recall floor
        ("same seed (a)", "l2", {}, None, corpus[:n2], queries[:256], side, 0.9),
        ("same seed (b)", "l2", {}, None, corpus[:n2], queries[:256], side, 0.9),
        ("l2sqr_sift uint8", "l2sqr_sift", dict(data_type=DataKind.UINT8, dist_type=DistKind.INT), None, cu8,
         np.rint(queries[:256]).astype(np.uint8), side, 0.9),
        ("cosinesimil clustered", "cosinesimil", {}, Params(dim=100), ang[:n2], ang[n2:], side, 0.9),
        ("nndRevMode=slots", "l2", {}, None, corpus[:n2], queries[:256], dict(side, nndRevMode="slots"), 0.85),
        ("nndStoreDtype=float32", "l2", {}, None, corpus[:n2], queries[:256], dict(side, nndStoreDtype="float32"),
         0.9),
        ("nndPolishStore=0", "l2", {}, None, corpus[:n2], queries[:256], dict(side, nndPolishStore=0), 0.9),
        ("D=960", "l2", {}, Params(dim=960), wide[:n2], wide[n2:], side, 0.9),
    )
    built = {}
    out["side"] = {}
    for label, name, kw, sparams, xs, qs, bp, floor in cells:
        ix = Index(name, sparams if sparams is not None else Params(dim=xs.shape[1]), device="cuda", **kw)
        (ix.add_uint8_batch if name == "l2sqr_sift" else ix.add_dense_batch)(xs)
        t0 = time.perf_counter()
        ix.build_index(Params(bp))
        torch.cuda.synchronize()
        bs = time.perf_counter() - t0
        chk = ix.method.check_graph()
        _, g_i = GoldStandard(ix.space, ix.store).compute_knn(qs, k)
        ix.set_query_time_params(Params(efSearch=50))
        rec = _recall_at(ix.knn_query_batch(qs, k)[1], g_i, k)
        wide_rows = xs.shape[1] * (1 if bp.get("nndStoreDtype", "int8") == "int8" else 4) >= TN.WIDE_ROW_BYTES
        print(f"[nnd] {label}, {n2} x {xs.shape[1]} {name}, {bp}: build {bs:.2f} s, check_graph {chk}, recall@{k} at "
              f"efSearch=50 {rec:.4f} (floor {floor}); wide-row branch {wide_rows}; {smi}", flush=True)
        _require(chk == zero and rec >= floor, lambda: f"nnd side cell {label}: check_graph {chk}, recall {rec}")
        out["side"][label] = {"build_s": bs, "recall": rec}
        if label.startswith("same seed"):
            built[label] = ix
        del ix
    a, b = built["same seed (a)"].method, built["same seed (b)"].method
    same = torch.equal(a.graph["level0"], b.graph["level0"]) and len(a._upper) > 0 and all(
        torch.equal(ua, ub) for ua, ub in zip(a._upper, b._upper))
    print(f"[nnd] same seed, {n2} rows: level 0 and {len(a._upper)} upper levels torch.equal {same}", flush=True)
    _require(same, lambda: "two NN-descent builds from one seed gave different graphs")
    del built, a, b
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    # ---- 1. environment ----
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(smi, flush=True)
    # the exact f32 tier: every f32 matmul on the path must be IEEE f32
    _require(torch.backends.cuda.matmul.allow_tf32 is False, lambda: "TF32 matmuls are enabled")
    _require(torch.get_float32_matmul_precision() == "highest",
             lambda: f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}")
    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.core.dataset import DenseDeviceData
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.spaces.dense import L2SqrSiftSpace, ensure_cert_metadata

    dev = torch.device("cuda", 0)
    t0 = _phase("environment", t0)

    # ---- 2. build ----
    libs = GM.build_all()
    root = GM.BUILD_DIR.parent.parent
    for name, lib in libs.items():
        print(f"[build] {lib.relative_to(root)} from {GM.SOURCES[name].relative_to(root)} for sm_90a; "
              + " | ".join(_ptxas_summary(GM.build_log.get(name, ""))), flush=True)
        for ln in GM.build_log.get(name, "").splitlines():
            if "warning" in ln.lower():
                print(f"[build] {name}: {ln.strip()}", flush=True)
        # ptxas reports what it does to the wgmma pipeline as "info" remarks:
        # C7514/C7515, the wgmmas of an instance serialized; C7519, a
        # warpgroup.arrive put in before a wgmma
        remarks = _ptxas_remarks(GM.build_log.get(name, ""))
        if remarks:
            print(f"[build] {name}: ptxas remarks per instance {json.dumps(remarks)}", flush=True)
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = _phase("build", t0)

    # ---- data (host numpy, made from a seed; set-up) ----
    xall = sift_like(N_CORPUS + N_QUERIES, DIM, seed=0)
    corpus, queries = xall[:N_CORPUS], xall[N_CORPUS:]
    t0 = _phase(f"data: sift_like({N_CORPUS + N_QUERIES}, {DIM}, seed=0)", t0)

    # ---- 3. kernel against its plain version (f64) ----
    max_abs_err = 0.0
    xs = torch.from_numpy(corpus[:N_KERNEL_CHECK]).to(dev)
    xts = (xs * xs).sum(1)
    for nq in (N_QUERIES, 1000):
        q = torch.from_numpy(queries[:nq]).to(dev)
        qt = (q * q).sum(1)
        out = GM.fused_groupmin(q, xs, qt, xts, -2.0)
        torch.cuda.synchronize()
        ref = GM.fused_groupmin_reference(q.double(), xs.double(), qt.double(), xts.double(), -2.0)
        bound, mag = _groupmin_bound(q, xs, qt, xts, -2.0)
        err = (out.double() - ref).abs()
        ratio = float((err / bound).max())
        max_abs_err = max(max_abs_err, float(err.max()))
        print(f"[kernel] Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - f64 plain| "
              f"{float(err.max()):.4g}, max relative {float((err / mag).max()):.3g} "
              f"(D*u = {DIM * U:.3g}), max error/bound {ratio:.3g}", flush=True)
        _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                 lambda: f"kernel output {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
        _require(ratio <= 1.0, lambda: f"kernel outside the f32 bound at Q={nq}: {ratio}")
    # the tensor-core tiers on the same rows: int8 on their uint8 rounding,
    # encoded as l2sqr_sift encodes them; bf16x3 and bf16 on the f32 rows
    kernel_err = {"int8": 0.0, "high": 0.0, "bfloat16": 0.0}
    cu8, qu8 = np.rint(corpus).astype(np.uint8), np.rint(queries).astype(np.uint8)
    a8, t8 = L2SqrSiftSpace._encode_mat(cu8[:N_KERNEL_CHECK])
    x8, xt8 = torch.from_numpy(a8).to(dev), torch.from_numpy(t8).to(dev)
    slab = DenseDeviceData(vecs=xs, ids=torch.arange(N_KERNEL_CHECK, dtype=torch.int32, device=dev),
                           count=N_KERNEL_CHECK, dim=DIM)
    ensure_cert_metadata(slab)
    for nq in (N_QUERIES, 1000):
        aq, tq = L2SqrSiftSpace._encode_mat(qu8[:nq])
        q8, qt8 = torch.from_numpy(aq).to(dev), torch.from_numpy(tq).to(dev)
        out = GM.fused_groupmin(q8, x8, qt8, xt8, -2.0)
        torch.cuda.synchronize()
        ref = GM.fused_groupmin_reference(q8, x8, qt8, xt8, -2.0)
        err = float((out - ref).abs().max())
        kernel_err["int8"] = max(kernel_err["int8"], err)
        print(f"[kernel] int8 Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - plain| {err:.4g}, "
              f"bit-equal {torch.equal(out, ref)}", flush=True)
        _require(torch.equal(out, ref), lambda: f"int8 kernel differs from its plain version at Q={nq}")
        q = torch.from_numpy(queries[:nq]).to(dev)
        qt = (q * q).sum(1)
        f32 = GM.fused_groupmin(q, xs, qt, xts, -2.0)
        _, mag = _groupmin_bound(q, xs, qt, xts, -2.0)
        for tier in ("high", "bfloat16"):
            out = GM.fused_groupmin(q, xs, qt, xts, -2.0, precision=tier)
            torch.cuda.synchronize()
            ref = GM.fused_groupmin_reference(q, xs, qt, xts, -2.0, precision=tier)
            diff = (out.double() - ref.double()).abs()
            rel = float((diff / mag).max())
            kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
            eps = SS._pass1_eps(q, slab, -2.0, tier).double()
            dev_f32 = (out.double() - f32.double()).abs().amax(dim=1)
            ratio = float((dev_f32 / eps).max())
            print(f"[kernel] {tier} Q={nq} N={N_KERNEL_CHECK} D={DIM}: max |kernel - plain| "
                  f"{float(diff.max()):.4g}, relative to the magnitude {rel:.3g} (limit 1e-5); "
                  f"max over queries of max_g |kernel - f32 kernel| / eps {ratio:.3g} "
                  f"(eps median {float(eps.median()):.4g})", flush=True)
            _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                     lambda: f"{tier} kernel output not finite or not {tuple(ref.shape)}")
            _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at Q={nq}: {rel} of the magnitude")
            _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at Q={nq}: {ratio}")
    del xs, xts, x8, xt8, slab
    _edge_sweep(dev, kernel_err)
    _edge_sweep_i8(dev, kernel_err)
    t0 = _phase("kernel vs plain", t0)

    # ---- 4. main path ----
    idx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    tb = time.perf_counter()
    idx.add_dense_batch(corpus)
    idx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.reset_launches()
    d10, i10 = idx.knn_query_batch(queries, K)
    launches = GM.launches["float32"]
    route = idx.method.last_route
    peak10 = torch.cuda.max_memory_allocated()
    print(f"[main] build {build_s:.3f} s for {N_CORPUS} x {DIM}; first query: route {route}, "
          f"groupmin launches {launches}", flush=True)
    print(f"[memory] index tensors {idx.memory_usage_bytes() / 2**30:.3f} GiB; peak allocated "
          f"during the k={K} query {peak10 / 2**30:.3f} GiB", flush=True)
    _require(route == "twopass", lambda: f"main path took the {route} route")
    _require(launches > 0, lambda: "the main path did not launch the group-min kernel")
    _require(d10.shape == (N_QUERIES, K) and i10.shape == (N_QUERIES, K),
             lambda: f"result shapes {d10.shape}, {i10.shape}")
    _require(np.isfinite(d10).all() and (np.diff(d10, axis=1) >= 0).all(),
             lambda: "distances not finite or not ascending")

    med, tmin, tmax = _median_ms(lambda: idx.knn_query_batch(queries, K))
    print(f"[main] knn_query_batch Q={N_QUERIES} k={K} over {N_CORPUS} x {DIM}: median "
          f"{med:.3f} ms of 7 (min {tmin:.3f}, max {tmax:.3f}), "
          f"{N_QUERIES / med * 1e3:.1f} qps on {smi}", flush=True)

    # per-stage device times of the same query (CUDA events)
    space, data = idx.space, idx.method.data
    stages, qenc = _breakdown(idx, queries, K)
    print("[breakdown] device ms per stage: " + json.dumps({k: round(v, 4) for k, v in stages.items()}),
          flush=True)

    # the kernel against its plain version at the main path's shapes
    scale, _, _ = space.pass1_affine()
    qk = qenc["q"]
    qtk = qenc["q_term"].contiguous()
    xtk = (data.extra["pad"] + data.row_term).contiguous()
    ms = _cuda_ms(lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale), 10)
    plain_ms = _cuda_ms(lambda: GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale), 3)
    k_out = GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale)
    p_out = GM.fused_groupmin_reference(qk, data.vecs, qtk, xtk, scale)
    bound, _ = _groupmin_bound(qk, data.vecs, qtk, xtk, scale)
    kp = float(((k_out.double() - p_out.double()).abs() / (2 * bound)).max())
    flops = 2.0 * qk.shape[0] * data.vecs.shape[0] * data.vecs.shape[1]
    bound_ms = {"float32": _bound_ms("float32", qk, data.vecs)}
    print(f"[kernel] main-path shapes Q={qk.shape[0]} N={data.vecs.shape[0]} D={data.vecs.shape[1]}: "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
          f"({flops / plain_ms / 1e9:.1f} TFLOP/s); |kernel - plain| / (2 * bound) max {kp:.3g}; "
          f"bound {bound_ms['float32'][0]:.3f} ms ({bound_ms['float32'][1]}), "
          f"{bound_ms['float32'][0] / ms:.1%} of it; {smi}", flush=True)
    _require(kp <= 1.0, lambda: f"kernel vs plain at the main path's shapes: {kp} of the bound")
    t0 = _phase("main path", t0)

    # ---- 5. float64 oracle ----
    q_dev = torch.from_numpy(queries).to(dev)
    x_dev = torch.from_numpy(corpus).to(dev)
    _check_against_oracle("knn_query_batch k=10", i10, d10, q_dev, x_dev, K)
    del x_dev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    d100, i100 = idx.knn_query_batch(queries, 100)
    print(f"[memory] peak allocated during the k=100 query "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    x_dev = torch.from_numpy(corpus).to(dev)
    _check_against_oracle("knn_query_batch k=100", i100, d100, q_dev, x_dev, 100)
    one = idx.knn_query(queries[0], K)
    _require(len(one) == K, lambda: f"knn_query returned {len(one)} results")
    _check_against_oracle("knn_query", one.ids[None, :], one.dists[None, :], q_dev[:1], x_dev, K)
    # both routes of _plan_knn at small sizes: 3000 rows stay single-pass,
    # 20000 rows padded to 1024-row chunks go two-pass
    for n, params, want in ((3000, {}, "single"), (20000, {"chunkSize": 1024}, "twopass")):
        small = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        small.add_dense_batch(corpus[:n])
        small.build_index(Params(params))
        ds, is_ = small.knn_query_batch(queries[:100], K)
        _require(small.method.last_route == want,
                 lambda: f"{n} rows took the {small.method.last_route} route")
        _check_against_oracle(f"{want} route, {n} rows", is_, ds, q_dev[:100], x_dev[:n], K)
    t0 = _phase("oracle", t0)

    # ---- 6. the int8 path: l2sqr_sift over the uint8 rounding of the corpus ----
    sidx = Index("l2sqr_sift", method="seq_search", data_type="dense_uint8_vector",
                 dist_type="int", device="cuda")
    tb = time.perf_counter()
    sidx.add_uint8_batch(cu8)
    sidx.build_index()
    torch.cuda.synchronize()
    build8_s = time.perf_counter() - tb
    GM.reset_launches()
    d8, i8 = sidx.knn_query_batch(qu8, K)
    launches8 = dict(GM.launches)
    route8 = sidx.method.last_route
    print(f"[int8] build {build8_s:.3f} s for {N_CORPUS} x {DIM} uint8; first query: route {route8}, "
          f"launches {launches8}", flush=True)
    _require(route8 == "twopass", lambda: f"the int8 path took the {route8} route")
    _require(launches8["int8"] > 0 and launches8["float32"] == 0,
             lambda: f"the int8 path launched {launches8}")
    med8, tmin8, tmax8 = _median_ms(lambda: sidx.knn_query_batch(qu8, K))
    print(f"[int8] knn_query_batch Q={N_QUERIES} k={K} over {N_CORPUS} x {DIM} uint8: median "
          f"{med8:.3f} ms of 7 (min {tmin8:.3f}, max {tmax8:.3f}), {N_QUERIES / med8 * 1e3:.1f} qps "
          f"(f32 path {med:.3f} ms) on {smi}", flush=True)
    stages8, qenc8 = _breakdown(sidx, qu8, K)
    print("[int8 breakdown] device ms per stage: "
          + json.dumps({k: round(v, 4) for k, v in stages8.items()}), flush=True)
    sdata = sidx.method.data
    qk8, qtk8 = qenc8["q"], qenc8["q_term"].contiguous()
    xtk8 = (sdata.extra["pad"] + sdata.row_term).contiguous()
    ms8 = _cuda_ms(lambda: GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0), 10)
    plain_ms8 = _cuda_ms(lambda: GM.fused_groupmin_reference(qk8, sdata.vecs, qtk8, xtk8, -2.0), 3)
    same8 = torch.equal(GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0),
                        GM.fused_groupmin_reference(qk8, sdata.vecs, qtk8, xtk8, -2.0))
    ops8 = 2.0 * qk8.shape[0] * sdata.vecs.shape[0] * sdata.vecs.shape[1]
    bound_ms["int8"] = _bound_ms("int8", qk8, sdata.vecs)
    print(f"[kernel] int8 main-path shapes Q={qk8.shape[0]} N={sdata.vecs.shape[0]} "
          f"D={sdata.vecs.shape[1]}: kernel {ms8:.3f} ms ({ops8 / ms8 / 1e9:.1f} TOP/s), plain "
          f"{plain_ms8:.3f} ms; bit-equal {same8}; bound {bound_ms['int8'][0]:.3f} ms "
          f"({bound_ms['int8'][1]}), {bound_ms['int8'][0] / ms8:.1%} of it; {smi}", flush=True)
    _require(same8, lambda: "int8 kernel differs from its plain version at the main path's shapes")
    # f32, int8, int8, f32 in turns at the two 1M indexes' shapes; the means of each pair
    f32_run = lambda: GM.fused_groupmin(qk, data.vecs, qtk, xtk, scale)  # noqa: E731
    i8_run = lambda: GM.fused_groupmin(qk8, sdata.vecs, qtk8, xtk8, -2.0)  # noqa: E731
    t4 = [_cuda_ms(f32_run, 10), _cuda_ms(i8_run, 10), _cuda_ms(i8_run, 10), _cuda_ms(f32_run, 10)]
    print("[kernel] int8 against the f32 kernel in turns (f32, int8, int8, f32): "
          + ", ".join(f"{t:.3f}" for t in t4) + f" ms; ratio {(t4[1] + t4[2]) / (t4[0] + t4[3]):.3f} (the "
          f"mma.sync kernel's {OLD_RATIO['int8'][1]}: {OLD_RATIO['int8'][0]} / 13.295 ms, NVIDIA H100 80GB "
          f"HBM3, 700 W); plan {json.dumps(GM.int8_plan(sdata.vecs.shape[1], -2.0))}", flush=True)
    # exact integer oracle: f64 products of uint8 values are exact
    q8_dev = torch.from_numpy(qu8).to(dev)
    x8_dev = torch.from_numpy(cu8).to(dev)
    od2, oi8 = _oracle_sq_topk(q8_dev, x8_dev, K)
    d8_t, i8_t = torch.as_tensor(d8, device=dev).double(), torch.as_tensor(i8, device=dev).long()
    exact8 = ((x8_dev[i8_t].double() - q8_dev.double()[:, None, :]) ** 2).sum(-1)
    distinct = bool((i8_t.sort(dim=1).values.diff(dim=1) > 0).all())
    _require(torch.equal(d8_t, od2), lambda: (
        f"int8 distances differ from the integer oracle at {int((d8_t != od2).sum())} slots"))
    _require(torch.equal(exact8, d8_t) and distinct, lambda: "an int8 id's exact distance is not the one returned")
    print(f"[oracle] int8 path: {N_QUERIES} queries x k={K}: distances equal to the exact integer "
          f"oracle at every slot; ids equal at {int((i8_t == oi8).sum())}/{i8_t.numel()} slots, the "
          f"others at exactly equal distances", flush=True)
    del x8_dev, sdata, qenc8, qk8, qtk8, xtk8
    torch.cuda.empty_cache()
    t0 = _phase("int8 path", t0)

    # ---- 9. range, on the indexes of phases 4 and 6 ----
    _phase_range(idx, sidx, queries, qu8, corpus, cu8, d10, d8, smi)
    del sidx
    torch.cuda.empty_cache()
    t0 = _phase("range", t0)

    # ---- 10. persist, phase 4's index ----
    _phase_persist(idx, queries, d10, i10)
    t0 = _phase("persist", t0)

    # ---- 7. the reduced tiers on the f32 main path ----
    tier_rec = {}
    for tier in ("high", "bfloat16"):
        idx.build_index(Params(pass1Precision=tier))
        GM.reset_launches()
        dt, it = idx.knn_query_batch(queries, K)
        lt = dict(GM.launches)
        m = idx.method
        print(f"[{tier}] route {m.last_route}, launches {lt}, certified {m.last_certified:.6f}, "
              f"redone blocks {m.last_redone_blocks} of {-(-N_QUERIES // SS._CERT_QBLK)}", flush=True)
        _require(m.last_route == "twopass" and lt[tier] > 0,
                 lambda: f"the {tier} path took the {m.last_route} route with launches {lt}")
        _same_results(f"{tier} k={K}", dt, it, d10, i10)
        medt, tmint, tmaxt = _median_ms(lambda: idx.knn_query_batch(queries, K))
        print(f"[{tier}] knn_query_batch Q={N_QUERIES} k={K}: median {medt:.3f} ms of 7 (min "
              f"{tmint:.3f}, max {tmaxt:.3f}), {N_QUERIES / medt * 1e3:.1f} qps; f32 tier "
              f"{med:.3f} ms; {smi}", flush=True)
        d100t, i100t = idx.knn_query_batch(queries, 100)
        print(f"[{tier}] k=100: route {m.last_route}, certified {m.last_certified:.6f}, redone "
              f"blocks {m.last_redone_blocks}", flush=True)
        _same_results(f"{tier} k=100", d100t, i100t, d100, i100)
        stagest, qenct = _breakdown(idx, queries, K, tier)
        print(f"[{tier} breakdown] device ms per stage: "
              + json.dumps({k: round(v, 4) for k, v in stagest.items()}), flush=True)
        tdata = m.data
        xtkt = (tdata.extra["pad"] + tdata.row_term).contiguous()
        qkt, qtkt = qenct["q"], qenct["q_term"].contiguous()
        # f32, reduced, reduced, f32 in turns; the means of each pair
        f32_run = lambda: GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale)  # noqa: E731
        new_run = lambda: GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)  # noqa: E731
        t4 = [_cuda_ms(f32_run, 10), _cuda_ms(new_run, 10), _cuda_ms(new_run, 10), _cuda_ms(f32_run, 10)]
        mst, ms32 = (t4[1] + t4[2]) / 2, (t4[0] + t4[3]) / 2
        plain_mst = _cuda_ms(lambda: GM.fused_groupmin_reference(
            qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier), 3)
        # the same kernel's output at these shapes: against its plain
        # version, and within the certificate's eps of the f32 kernel
        out = GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)
        ref = GM.fused_groupmin_reference(qkt, tdata.vecs, qtkt, xtkt, scale, precision=tier)
        f32 = GM.fused_groupmin(qkt, tdata.vecs, qtkt, xtkt, scale)
        _, mag = _groupmin_bound(qkt, tdata.vecs, qtkt, xtkt, scale)
        diff = (out.double() - ref.double()).abs()
        rel = float((diff / mag).max())
        kernel_err[tier] = max(kernel_err[tier], float(diff.max()))
        eps = SS._pass1_eps(qkt, tdata, scale, tier).double()
        ratio = float(((out.double() - f32.double()).abs().amax(dim=1) / eps).max())
        bound_ms[tier] = _bound_ms(tier, qkt, tdata.vecs)
        print(f"[kernel] {tier} main-path shapes Q={qkt.shape[0]} N={tdata.vecs.shape[0]} "
              f"D={tdata.vecs.shape[1]}: kernel {mst:.3f} ms ({flops / mst / 1e9:.1f} TFLOP/s of the "
              f"f32 product), f32 kernel {ms32:.3f} ms, plain {plain_mst:.3f} ms; max |kernel - plain| "
              f"{float(diff.max()):.4g}, relative to the magnitude {rel:.3g} (limit 1e-5); max over "
              f"queries of max_g |kernel - f32 kernel| / eps {ratio:.3g}; bound {bound_ms[tier][0]:.3f} ms "
              f"({bound_ms[tier][1]}), {bound_ms[tier][0] / mst:.1%} of it; {smi}", flush=True)
        print(f"[kernel] {tier} against the f32 kernel in turns (f32, {tier}, {tier}, f32): "
              + ", ".join(f"{t:.3f}" for t in t4) + f" ms; ratio {mst / ms32:.3f} (the mma.sync kernel's "
              f"{OLD_RATIO[tier][1]}: {OLD_RATIO[tier][0]} / 13.294 ms, NVIDIA H100 80GB HBM3, 700 W)",
              flush=True)
        _require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                 lambda: f"{tier} kernel output not finite or not {tuple(ref.shape)} at the main path's shapes")
        _require(rel <= 1e-5, lambda: f"{tier} kernel vs plain at the main path's shapes: {rel} of the magnitude")
        _require(ratio <= 1.0, lambda: f"{tier} kernel beyond eps of the f32 kernel at the main path's shapes: {ratio}")
        tier_rec[tier] = {"launches": lt[tier], "ms": mst, "plain_ms": plain_mst, "f32_ms": ms32}
        del dt, it, d100t, i100t, tdata, qenct, qkt, qtkt, xtkt, out, ref, f32, mag, diff, eps
        torch.cuda.empty_cache()
    t0 = _phase("reduced tiers", t0)

    # ---- 8. forced fallback: row 5 copied into 39 other groups ----
    # Both failing queries lie in the first 256-query block, which re-runs
    # the f32 kernel. Under "high" the second block certifies, so its
    # reduced selection drives pass 2; "bfloat16" certifies fewer queries.
    base = corpus[:20000].copy()
    for g in range(1, 40):
        base[g * 128 + 7] = base[5]
    fq = queries[:512].copy()
    fq[10] = base[5] + 0.125
    fq[200] = base[5] + 0.25
    x_f = torch.from_numpy(base).to(dev)
    for tier in ("high", "bfloat16"):
        fidx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
        fidx.add_dense_batch(base)
        fidx.build_index(Params(chunkSize=1024, pass1Precision=tier))
        GM.reset_launches()
        df, if_ = fidx.knn_query_batch(fq, K)
        lf = dict(GM.launches)
        m = fidx.method
        print(f"[fallback] {tier}: route {m.last_route}, certified {m.last_certified:.6f}, redone "
              f"blocks {m.last_redone_blocks} of 2, launches {lf}", flush=True)
        _require(m.last_route == "twopass" and m.last_redone_blocks > 0 and lf["float32"] > 0
                 and lf[tier] > 0, lambda: f"{tier}: the certificate did not fall back ({lf})")
        _require(tier != "high" or m.last_redone_blocks < 2, lambda: (
            "high: the second block did not certify, so no reduced selection reached pass 2"))
        _check_against_oracle(f"forced fallback {tier}", if_, df, torch.from_numpy(fq).to(dev), x_f, K)
    del x_f
    t0 = _phase("forced fallback", t0)

    # ---- 8b. gist-960's width end to end: the reduced tiers in K chunks ----
    from tpu_knn_torch.eval.datasets import sift_like

    wide = sift_like(20_096 + 256, 960, seed=3)
    wq = wide[20_096:]
    widx = Index("l2", Params(dim=960), method="seq_search", device="cuda")
    widx.add_dense_batch(wide[:20_096])
    dw, iw = widx.knn_query_batch(wq, K)
    _check_against_oracle("D=960 f32", iw, dw, torch.from_numpy(wq).to(dev),
                          torch.from_numpy(wide[:20_096]).to(dev), K)
    for tier in ("high", "bfloat16"):
        widx.build_index(Params(pass1Precision=tier))
        GM.reset_launches()
        dwt, iwt = widx.knn_query_batch(wq, K)
        lw = dict(GM.launches)
        print(f"[wide] {tier} D=960: route {widx.method.last_route}, certified "
              f"{widx.method.last_certified:.6f}, launches {lw}", flush=True)
        _require(widx.method.last_route == "twopass" and lw[tier] > 0,
                 lambda: f"D=960 {tier}: route {widx.method.last_route}, launches {lw}")
        _same_results(f"D=960 {tier} k={K}", dwt, iwt, dw, iw)
    del widx, wide
    t0 = _phase("gist-960 width", t0)

    # ---- 11 and 12. the scalar-product spaces at the glove-100-angular shape,
    # the gold standard and the metrics ----
    del idx
    torch.cuda.empty_cache()
    _phase_angular(smi)
    t0 = _phase("angular, gold standard and metrics", t0)

    # ---- 13. precision of the single-pass scan ----
    _phase_precision(corpus, queries, smi)
    t0 = _phase("precision", t0)

    # ---- 14. a NaN distance on the card ----
    _phase_nan(smi)
    t0 = _phase("nan", t0)

    # ---- 15. hnsw, the default method ----
    hn = _phase_hnsw(smi)
    t0 = _phase("hnsw", t0)
    print("[hnsw] " + json.dumps({"build_s": round(hn["build_s"], 2), "build_peak_gib": round(hn["build_peak_gib"], 3),
                                  "qps_recall": {str(ef): [round(r["qps"]), round(r["recall"], 4)]
                                                 for ef, r in hn["search"].items()}}) + f"; {smi}", flush=True)

    # ---- 16. nnd: the default index at SIFT-1M, built by NN-descent ----
    nd = _phase_nnd(smi, corpus, queries, i10)
    del corpus, queries
    t0 = _phase("nnd", t0)
    print("[nnd] " + json.dumps({
        "build_s": nd["build_s"], "build_peak_gib": nd["peak_gib"], "phases": nd["phases"], "sweeps": nd["sweeps"],
        "repaired": nd["repaired"], "unreached": nd["unreached"],
        "qps_recall": {str(ef): [r["qps"], r["recall"]] for ef, r in nd["search"].items()},
        "side": nd["side"]}) + f"; {smi}", flush=True)

    src_wgmma = "tpu_knn_torch/csrc/groupmin_wgmma.cu"
    rows = [
        ("groupmin_f32", "float32", "tpu_knn_torch/csrc/groupmin.cu", "tpu_knn/ops/pallas_scan.py:182",
         launches, max_abs_err, ms, plain_ms),
        ("groupmin_i8", "int8", "tpu_knn_torch/csrc/groupmin_wgmma_i8.cu", "tpu_knn/ops/pallas_scan.py:111",
         launches8["int8"], kernel_err["int8"], ms8, plain_ms8),
        ("groupmin_bf16x3", "high", src_wgmma, "tpu_knn/ops/pallas_scan.py:120", tier_rec["high"]["launches"],
         kernel_err["high"], tier_rec["high"]["ms"], tier_rec["high"]["plain_ms"]),
        ("groupmin_bf16", "bfloat16", src_wgmma, "tpu_knn/ops/pallas_scan.py:118",
         tier_rec["bfloat16"]["launches"], kernel_err["bfloat16"], tier_rec["bfloat16"]["ms"],
         tier_rec["bfloat16"]["plain_ms"]),
    ]
    # no single PyTorch call computes a group min, so no library time
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n_launch,
         "max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bound_ms[tier][0],
         "bound_by": bound_ms[tier][1], "library_ms": None}
        for name, tier, src, rep, n_launch, err, kms, pms in rows
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
