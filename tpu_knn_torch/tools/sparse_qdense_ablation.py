"""Ablation of the sparse scan kernel (``csrc/sparse_qdense.cu``) on one CUDA
card: which part of the kernel its time goes to.

Run from the root of a checkout::

    python3 -m tpu_knn_torch.tools.sparse_qdense_ablation [--reps 5] [--rows 1000000]

It writes variants of the source into a temporary directory, each with one
part switched off, builds them side by side with the port's nvcc flags
(the libraries go into the same temporary directory, removed at the end),
and times every variant over the 1M ``cosinesimil_sparse`` cell of
``chip_smoke.py`` (``sparse_like(rows + 512, vocab=60_000, nnz=64,
seed=0)``, 512 queries, the cosine form in the scan's 4080-row launches)
and over the dense-table cell of ``tools/sparse_scan_profile.py`` (vocab
1,024, 100,000 rows). Each variant runs in turns with the full kernel
(full, variant, variant, full), by CUDA events over every launch of the
corpus (mean of ``--reps``), and once under ``torch.profiler``, whose
device time of the kernel it prints too (the events' times include any
gap the host leaves between launches). A variant's output is wrong by design; the full kernel's
is checked ``torch.equal`` to the port's own ``qdense_dists``. Variants:

  full         the kernel as shipped;
  no_walk      no slot is walked: the sums stay 0 (the launch, the
               zeroing, the first group's loads and the epilogue);
  no_post      the epilogue writes the sums as they are (no post);
  no_store     the epilogue computes the posts but stores none;
  no_rare      the rare path is never taken: runs past their second record,
               runs longer than L and non-finite weights add nothing;
  lib_div      the posts divide with the library's __fdiv_rn, not the
               kernel's inline div_rn (the same quotients: the tool says
               whether each variant's output equals the full kernel's, bit
               for bit);
  no_gathers   the spans come from the slot's id, not from memory (no span
               load; runs of 0 to 2 synthetic records in the lane's own
               cells).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import tempfile

#: variant -> text patches of csrc/sparse_qdense.cu
VARIANTS = {
    "full": [],
    "no_walk": [("for (int t0 = 0; t0 < nnz; t0 += 2 * G) {", "for (int t0 = 0; t0 < 0; t0 += 2 * G) {")],
    "no_post": [("const float dd = post<F>(acc[q * 32 + swz(lane, q / QT)], s_qn[q], xn, s_ql[q], xl);",
                 "const float dd = acc[q * 32 + swz(lane, q / QT)];")],
    "no_store": [("o[(int64_t)q * c] = __fadd_rn(dd, pr);",
                  "if (dd == 12345.f) o[(int64_t)q * c] = __fadd_rn(dd, pr);")],
    "no_rare": [("if (__any_sync(FULL, own > 2 || len > L || !fin))", "if (false)")],
    "lib_div": [("  if (F == QUERYNORM) return div_rn(", "  if (F == QUERYNORM) return __fdiv_rn("),
                ("    return clamp_min_nan(__fsub_rn(1.0f, div_rn(dot,", "    return clamp_min_nan(__fsub_rn(1.0f, __fdiv_rn(dot,"),
                ("  if (F == ANGULAR) return acosf(clamp_nan(div_rn(dot,", "  if (F == ANGULAR) return acosf(clamp_nan(__fdiv_rn(dot,"),
                ("  return u > 0.0f ? __fsub_rn(1.0f, div_rn(dot,", "  return u > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(dot,")],
    "no_gathers": [
        ("run[s] = __ldg(qs + (real ? (int64_t)(min(col, v) - 1) * tiles : pend));",
         "run[s] = make_int4(0, (((col & 7) == 0) + ((col & 63) == 0)) | (col & 31) << 8 | ((col + 1) & 31) << 16, "
         "0x3f800000, 0x3f800000);")],
}


def _build(out_dir: str) -> dict:
    from tpu_knn_torch.ops import groupmin as GM

    src = GM.SOURCES["sparse_qdense"].read_text()
    shutil.copy(GM.INCLUDE_DIR / "min_nan.cuh", out_dir)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([GM._nvcc(), *GM.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i64, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        print(f"[build] {name}: " + " | ".join(ln.strip() for ln in log.splitlines()
                                               if "registers" in ln or "spill" in ln), flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.tk_sparse_qdense.argtypes = [ci, vp, vp, i64, i64, vp, vp, i64, ci, vp, vp, vp, vp, vp, vp]
        lib.tk_sparse_qdense.restype = ci
        libs[name] = lib
    return libs


def _cell(n: int, vocab: int, nq: int, chunk: int):
    """(postings, query norms, the corpus's launch slices, the port's own outputs) of a cell."""
    import torch

    from tpu_knn_torch import DataKind, Index
    from tpu_knn_torch.eval.datasets import sparse_like
    from tpu_knn_torch.ops import sparse as S

    pts = sparse_like(n + nq, vocab=vocab, nnz=64, seed=0)
    ix = Index("cosinesimil_sparse", method="seq_search", data_type=DataKind.SPARSE, device="cuda")
    ix.add_sparse_batch(pts[:n], ids=range(n))
    ix.build_index()
    space, data = ix.method.space, ix.method.data
    qenc = space.densify_queries(space.encode_queries(pts[n:]), space.slice_data(data, 0, chunk), scan=True)
    post, qn = qenc["q_post"], qenc["qnorm"]
    sl = [space.slice_data(data, s, chunk) for s in range(0, data.ids.shape[0], chunk)]
    ref = [S.qdense_dists("cosine", post, x["cols"], x["x"], qn, None, None, x["pad"]) for x in sl]
    torch.cuda.synchronize()
    return post, qn, sl, ref


def _device_ms(prof) -> float:
    """The kernel's device time in a profile, ms."""
    return sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) for e in prof.key_averages()
               if "sparse_qdense" in e.key) / 1e3


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sparse_qdense_ablation needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="tk_sq_ablation_")
    try:
        libs = _build(tmp)
        for cell, n, vocab in (("1M", args.rows, 60_000), ("dense", 100_000, 1_024)):
            post, qn, sl, ref = _cell(n, vocab, 512, 4080)
            outs = [torch.empty_like(r) for r in ref]
            stream = torch.cuda.current_stream().cuda_stream

            def run(lib):
                for x, o in zip(sl, outs):
                    err = lib.tk_sparse_qdense(2, post.span.data_ptr(), post.rec.data_ptr(), post.v, post.nq,
                                               x["cols"].data_ptr(), x["x"].data_ptr(), x["cols"].shape[0],
                                               x["cols"].shape[1], qn.data_ptr(), None, None, x["pad"].data_ptr(),
                                               o.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")

            def events_ms(lib):
                run(lib)
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(args.reps):
                    run(lib)
                b.record()
                torch.cuda.synchronize()
                return a.elapsed_time(b) / args.reps

            run(libs["full"])
            torch.cuda.synchronize()
            same = all(torch.equal(o, r) for o, r in zip(outs, ref))
            full_out = [o.clone() for o in outs]
            print(f"[ablation] {cell}: {len(sl)} launches of 4080 rows x 512 queries; the full kernel "
                  f"{'equals' if same else 'DIFFERS FROM'} qdense_dists; {smi}", flush=True)
            for name, lib in libs.items():
                if name == "full":
                    continue
                run(lib)
                torch.cuda.synchronize()
                equal = all(torch.equal(o.view(torch.int32), r.view(torch.int32)) for o, r in zip(outs, full_out))
                turns = [events_ms(libs["full"]), events_ms(lib), events_ms(lib), events_ms(libs["full"])]
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run(lib)
                    torch.cuda.synchronize()
                dev = _device_ms(prof)
                print(f"[ablation] {cell} {name}: full / variant / variant / full "
                      + " / ".join(f"{t:.3f}" for t in turns)
                      + f" ms (CUDA events, mean of {args.reps}); variant's device time {dev:.3f} ms "
                      f"(torch.profiler); output {'equal to' if equal else 'differs from'} the full kernel's, bit "
                      f"for bit; {smi}", flush=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(libs["full"])
                torch.cuda.synchronize()
            dev = _device_ms(prof)
            print(f"[ablation] {cell} full: device time {dev:.3f} ms (torch.profiler); {smi}", flush=True)
            del post, qn, sl, ref, outs, full_out
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
