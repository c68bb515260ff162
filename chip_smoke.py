#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_knn_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc (under CUDA_HOME or /usr/local/cuda, or on PATH) and the
checkout's sources; it imports neither jax nor tpu_knn. Phases, each
printed as it ends, each fatal on failure:

 1. environment: torch/CUDA versions, the card's name and power limit;
    IEEE f32 matmuls (no TF32) required;
 2. build: compile csrc/groupmin.cu for sm_90a;
 3. the group-min kernel against its plain PyTorch version computed in
    float64, on 131072 sift_like rows, Q in {2048, 1000 (ragged)};
 4. the main path: Index("l2", Params(dim=128), method="seq_search",
    device="cuda") over 1,000,000 sift_like rows (the SIFT-1M shape of
    ann-benchmarks' sift-128-euclidean), 2048 queries at k=10, on the
    two-pass route, with the kernel's launch count, build and query times,
    a per-stage breakdown and the kernel's time against the plain version;
 5. a float64 oracle (plain chunked torch product, independent of the
    code under test) for all 2048 queries at k=10 and k=100, for one
    knn_query, and for both routes at small sizes (3000 rows single-pass,
    20000 rows two-pass).

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA card or any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
    return best_d.clamp_min(0).sqrt(), best_i


def _check_against_oracle(label, ids, dists, q, x, k):
    """Ids must equal the oracle's except on ties. The returned f32
    distances must be within the f32 norm-identity bound
    B = (D+3)*u*(|q|+|x|)^2 of the exact squared distance, so an f32 scan
    cannot order two ids whose exact squared distances differ by less than
    2B: a tie is an exact distance within 1e-5 relative of the oracle's at
    that rank, or a squared distance within 2B of it."""
    import torch

    dev = q.device
    od, oi = _oracle_topk(q, x, k)
    ids_t = torch.as_tensor(ids, device=dev)
    _require(ids_t.shape == oi.shape and bool((ids_t >= 0).all()), lambda: f"{label}: missing results")
    diff = ids_t != oi
    q64 = q.double()
    xr = x[ids_t].double()  # [Q, k, D] rows of the returned ids
    exact = ((xr - q64[:, None, :]) ** 2).sum(-1)  # f64 squared distances
    bound = (q.shape[1] + 3) * U * (q64.norm(dim=1)[:, None] + xr.norm(dim=-1)) ** 2
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
    import numpy as np

    from tpu_knn_torch import Index, Params
    from tpu_knn_torch.eval.datasets import sift_like
    from tpu_knn_torch.methods import seq_search as SS
    from tpu_knn_torch.ops import groupmin as GM
    from tpu_knn_torch.ops import topk as T

    dev = torch.device("cuda", 0)
    t0 = _phase("environment", t0)

    # ---- 2. build ----
    lib = GM.build()
    ptxas = [ln.strip() for ln in GM.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] {lib.relative_to(GM.BUILD_DIR.parent.parent)} from "
          f"{GM.SOURCE.relative_to(GM.BUILD_DIR.parent.parent)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s; " + " | ".join(ptxas), flush=True)
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
    del xs, xts
    t0 = _phase("kernel vs plain", t0)

    # ---- 4. main path ----
    idx = Index("l2", Params(dim=DIM), method="seq_search", device="cuda")
    tb = time.perf_counter()
    idx.add_dense_batch(corpus)
    idx.build_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    torch.cuda.reset_peak_memory_stats()
    GM.launches = 0
    d10, i10 = idx.knn_query_batch(queries, K)
    launches = GM.launches
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

    times = []
    for _ in range(7):
        ts = time.perf_counter()
        idx.knn_query_batch(queries, K)  # returns host numpy: synchronized
        times.append(time.perf_counter() - ts)
    med = statistics.median(times)
    print(f"[main] knn_query_batch Q={N_QUERIES} k={K} over {N_CORPUS} x {DIM}: median "
          f"{med * 1e3:.3f} ms of {len(times)} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}), {N_QUERIES / med:.1f} qps on {smi}", flush=True)

    # per-stage device times of the same query (CUDA events)
    space, data = idx.space, idx.method.data
    qpts, _ = idx._bucket_query_points(queries)
    qenc = space.encode_queries(qpts)
    mins = SS._pass1(space, qenc, data)
    kg = min(K + SS._PASS1_MARGIN, data.ids.shape[0] // T.GROUP)
    _, gsel = T.smallest_k(mins, kg)
    stages = {
        "encode_queries": _cuda_ms(lambda: space.encode_queries(qpts), 5),
        "pass1_groupmin": _cuda_ms(lambda: SS._pass1(space, qenc, data), 5),
        "select_groups": _cuda_ms(lambda: T.smallest_k(mins, kg), 5),
        "pass2_gather_rescore": _cuda_ms(lambda: SS._pass2(space, qenc, data, gsel, K), 5),
    }
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
    print(f"[kernel] main-path shapes Q={qk.shape[0]} N={data.vecs.shape[0]} D={data.vecs.shape[1]}: "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
          f"({flops / plain_ms / 1e9:.1f} TFLOP/s); |kernel - plain| / (2 * bound) max {kp:.3g}; "
          f"{smi}", flush=True)
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

    record = {"kernels": [{
        "name": "groupmin_f32",
        "route": "cuda",
        "source": "tpu_knn_torch/csrc/groupmin.cu",
        "replaces": "tpu_knn/ops/pallas_scan.py:182",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
