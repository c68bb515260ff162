"""Ablation of the wgmma group-min kernels (``csrc/groupmin_wgmma.cu``:
bf16x3 and bf16; ``csrc/groupmin_wgmma_i8.cu``: int8) on one CUDA card:
which part of each kernel its time goes to.

Run from the root of a checkout::

    python3 -m tpu_knn_torch.tools.groupmin_ablation [--reps 12] [--only wgmma|int8]
        [--against OTHER.cu] [--against-i8 OTHER_I8.cu] [--against-f32 OTHER_F32.cu]
        [--dims 128,256] [--only against]

It writes variants of the source into a temporary directory, each with
some parts switched off, builds them side by side with the port's nvcc
flags (the libraries go into the same temporary directory, removed at the
end), and times every variant on the 1M x 128 ``l2`` shape of
``chip_smoke.py`` (Q=2048, N=1,007,616, random rows), bf16x3 and bf16.
Each variant runs in ``--reps`` rounds of turns with the full kernel
(full, variant, variant, full, so that a drift of the clock cancels); per
variant it prints the median time and the median, least and largest of
its per-round ratio to the full kernel. A variant's
output is wrong by design; only the full kernel is checked against its
plain version (within 1e-5 of the magnitude). Variants:

  full        the kernel as shipped;
  half_mma    only every second k-step's products are issued (int8: the
              first two k-steps of each slab);
  no_store    the epilogue computes the mins but stores none;
  epi4        the epilogue reads a quarter of the accumulators;
  no_split    the corpus tile is neither loaded nor split (x_term is);
  no_db       one corpus buffer: the consumers split each tile between
              tiles (the full kernel's bf16 at D=128 has two);
  mma_only    no_split, no_store and an epilogue that reads 4 of the 64
              accumulators (reading none lets ptxas drop the products):
              the query ring and the products alone.

Then it samples the card's SM clock and power (``nvidia-smi``) while the
full bf16 kernel runs back to back for about 3 s, and times both tiers and
the f32 kernel in turns at gist-960's width (Q=1000, N=1,000,064, D=960),
where the kernel runs in K chunks.

The int8 kernel runs the same rounds on the 1M x 128 ``l2sqr_sift`` shape
(uniform random int8 rows, scale -2): ``half_mma``, ``no_store``, ``epi4``,
``no_split`` and ``mma_only`` as above (``mma_only`` reads 8 of the 64
accumulators); a test of whether CUDA-core work of one warpgroup runs
under the products of another:

  mma_ffma    mma_only plus 256 dependent-chain FFMAs a thread in every
              epilogue (about the real epilogue's instruction count);
  ffma_only   the same without the products;
  empty_loop  neither: the ring, the barriers and the 8-accumulator
              epilogue (mma_ffma near mma_only + ffma_only - empty_loop
              means the two kinds of work add up and do not overlap);

and variants of the design that keep the result, each held bit-equal
(``torch.equal``) to the plain version like the full kernel:

  no_db       one corpus buffer (the full kernel at D=128 has two);
  one_group   one 128-row group and one accumulator set a consumer
              warpgroup, a 256-row corpus tile, one buffer (the full
              kernel: two groups, their products issued in turns);
  xreg0/xreg2 x_term of none / both of a warpgroup's two groups in
              registers (the full kernel: of one; the rest is read from
              shared memory in every epilogue);
  no_fma      multiply, then add, where the full kernel fuses them
              (scale a power of two);
  cvt_magic   s32 -> f32 by an integer add and a subtraction instead of
              the convert instruction (exact while |dot| < 2^22).

Then the SM clock under the full int8 kernel, and the kernel at D in 256,
384, 640, 960 (its other layouts) beside its bound.

With ``--against`` (``--against-i8``, ``--against-f32``), another version
of the bf16 (int8, f32 ``csrc/groupmin.cu``) source with the same entry
points is built beside it and both are timed in turns (shipped, other,
other, shipped) at each D of ``--dims`` (default 128, 256, 384, 960;
Q=2048, N=1,007,616), and their outputs compared (``torch.equal``).
``--only against`` runs these comparisons and no ablation. Prints the
card's name and power limit. Needs torch with CUDA and nvcc; imports neither jax nor tpu_knn.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

#: part -> (text that must be in the source exactly once, its replacement)
PATCHES = {
    "half_mma": ("          if (kk < ks) {", "          if (kk < ks && (kk & 1)) {"),
    "no_store": ("      if (live && tq == 0) {", "      if (live && tq == 0 && m0 == -1.2345e-30f) {"),
    "epi4": ("      for (int j = 0; j < 16; ++j) {", "      for (int j = 0; j < 4; ++j) {"),
    "epi1": ("      for (int j = 0; j < 16; ++j) {", "      for (int j = 0; j < 1; ++j) {"),
    "no_split": ("  for (int c = 8 * s0 + (tid & 15); c < ch; c += 16) {",
                 "  for (int c = 8 * s0 + (tid & 15); c < 0; c += 16) {"),
    "no_db": ("    for (int nb = 2; nb >= 1; --nb) {", "    for (int nb = 1; nb >= 1; --nb) {"),
}
VARIANTS = {
    "full": (),
    "half_mma": ("half_mma",),
    "no_store": ("no_store",),
    "epi4": ("epi4",),
    "no_split": ("no_split",),
    "no_db": ("no_db",),
    "mma_only": ("no_split", "no_store", "epi1"),
}
ENTRIES = {"high": "tk_groupmin_bf16x3", "bfloat16": "tk_groupmin_bf16"}

#: the int8 source's parts, likewise
PATCHES_I8 = {
    "half_mma": ("  if (ks >= 4)\n    wgmma_slab<4, NG>(", "  if (ks >= 4)\n    wgmma_slab<2, NG>("),
    "no_store": ("      if (grp < a.n_groups && tq == 0) {",
                 "      if (grp < a.n_groups && tq == 0 && m0 == -1.2345e-30f) {"),
    "epi4": ("      for (int j2 = 0; j2 < 8; ++j2) {", "      for (int j2 = 0; j2 < 2; ++j2) {"),
    "epi1": ("      for (int j2 = 0; j2 < 8; ++j2) {", "      for (int j2 = 0; j2 < 1; ++j2) {"),
    "no_split": ("  for (int base = tid; base < total; base += U * nthreads) {",
                 "  for (int base = tid; base < 0; base += U * nthreads) {"),
    "no_db": ("  const int tiles[4][3] = {{2, 2, 2}, ", "  const int tiles[4][3] = {{2, 2, 1}, "),
    "one_group": ("  const int tiles[4][3] = {{2, 2, 2}, {2, 2, 1}, ", "  const int tiles[4][3] = {{2, 1, 1}, {2, 1, 1}, "),
    "xreg0": ("constexpr int XREG = 1;", "constexpr int XREG = 0;"),
    "xreg2": ("constexpr int XREG = 1;", "constexpr int XREG = 2;"),
    "no_mma": ("  for (int kk = 0; kk < N; ++kk)\n", "  for (int kk = 0; kk < 0; ++kk)\n"),
    # 256 FFMAs a thread and unit in four chains, about the epilogue's instruction count
    "ffma": ("      m0 = min_nan(m0, n0);\n",
             "      {\n        float d0 = m0, d1 = m1, d2 = n0, d3 = n1;\n#pragma unroll\n"
             "        for (int i = 0; i < 64; ++i) {\n          d0 = fmaf(d0, 1.0001f, 0.5f);\n"
             "          d1 = fmaf(d1, 1.0001f, 0.5f);\n          d2 = fmaf(d2, 1.0001f, 0.5f);\n"
             "          d3 = fmaf(d3, 1.0001f, 0.5f);\n        }\n"
             "        m0 += (d0 + d1 + d2 + d3) * 1e-30f;\n      }\n      m0 = min_nan(m0, n0);\n"),
    "no_fma": ("  if (POW2) return __fmaf_rn(", "  if (false) return __fmaf_rn("),
    "cvt_magic": ("float cvt(int s) { return __int2float_rn(s); }",
                  "float cvt(int s) { return __int_as_float(s + 0x4B400000) - 12582912.f; }"),
}
VARIANTS_I8 = {
    "full": (),
    "half_mma": ("half_mma",),
    "no_store": ("no_store",),
    "epi4": ("epi4",),
    "no_split": ("no_split",),
    "mma_only": ("no_split", "no_store", "epi1"),
    "mma_ffma": ("no_split", "no_store", "epi1", "ffma"),
    "ffma_only": ("no_split", "no_store", "epi1", "ffma", "no_mma"),
    "empty_loop": ("no_split", "no_store", "epi1", "no_mma"),
    "no_db": ("no_db",),
    "one_group": ("one_group",),
    "xreg0": ("xreg0",),
    "xreg2": ("xreg2",),
    "no_fma": ("no_fma",),
    "cvt_magic": ("cvt_magic",),
}
#: int8 variants that compute the same function: held bit-equal to plain
EXACT_I8 = ("full", "no_db", "one_group", "xreg0", "xreg2", "no_fma", "cvt_magic")


def variant_source(src: str, parts, patches=None) -> str:
    """``src`` with each named part of ``patches`` (default: the bf16
    source's) switched off; raises if a part's text is not in the source
    exactly once (the kernel changed under it)."""
    for part in parts:
        old, new = (PATCHES if patches is None else patches)[part]
        if src.count(old) != 1:
            raise RuntimeError(f"ablation part {part!r}: {old.strip()!r} is not in the kernel source once")
        src = src.replace(old, new)
    return src


def spills(log: str) -> dict:
    """{template arguments of a kernel instance: its spill line} for the
    instances of nvcc's -Xptxas=-v output that spill registers."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '.*?_kernelI(\w*)", ln)
        if m:
            name = ",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
        elif "entry function" in ln:
            name = None
        elif name is not None and int((re.search(r"(\d+) bytes spill stores", ln) or [0, 0])[1]):
            out[name] = ln.strip()
    return out


def _cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back runs (CUDA events), after one warm-up."""
    import torch

    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _watchdog(last, limit_s: float) -> None:
    """Exit the process if no step finishes within limit_s (a variant that hangs)."""
    def watch():
        while True:
            time.sleep(1.0)
            if time.time() - last[0] > limit_s:
                print(f"groupmin_ablation: no progress in {limit_s} s", flush=True)
                os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def _inputs(nq, n, d, seed):
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=gen) * 30
    q = torch.randn(nq, d, device=dev, generator=gen) * 30
    return q, x, (q * q).sum(1), (x * x).sum(1)


def _magnitude(q, x, qt, xt, scale):
    """|scale||q||x| + |x_term| + |q_term| per (query, group), row terms at their group max."""
    xn = x.double().norm(dim=1).view(-1, 128).amax(1)[None, :]
    xtm = xt.double().abs().view(-1, 128).amax(1)[None, :]
    return abs(scale) * q.double().norm(dim=1)[:, None] * xn + xtm + qt.double().abs()[:, None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=12, help="rounds of turns (default 12)")
    ap.add_argument("--only", choices=("wgmma", "int8", "against"),
                    help="ablate one of the two sources only, or none (the --against comparisons alone)")
    ap.add_argument("--against", type=Path, help="another groupmin_wgmma.cu to time beside the shipped one")
    ap.add_argument("--against-i8", type=Path, help="another groupmin_wgmma_i8.cu, likewise")
    ap.add_argument("--against-f32", type=Path, help="another groupmin.cu, likewise")
    ap.add_argument("--dims", default="128,256,384,960", help="widths of the --against comparisons")
    args = ap.parse_args(argv)
    import torch

    from tpu_knn_torch.ops import groupmin as GM

    if not torch.cuda.is_available():
        print("groupmin_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    last = [time.time()]
    _watchdog(last, 120.0)
    src = GM.SOURCES["groupmin_wgmma"].read_text()
    src8 = GM.SOURCES["groupmin_wgmma_i8"].read_text()
    dims = [int(v) for v in args.dims.split(",")]
    with tempfile.TemporaryDirectory(prefix="groupmin_ablation_") as tmp_dir:
        tmp = Path(tmp_dir)
        GM.BUILD_DIR = tmp
        # variant name -> its library's name in GM.SOURCES, per source
        variants = {} if args.only in ("int8", "against") else {n: f"ablation_{n}" for n in VARIANTS}
        variants8 = {} if args.only in ("wgmma", "against") else {n: f"ablation_i8_{n}" for n in VARIANTS_I8}
        for name, lname in variants.items():
            (tmp / f"{name}.cu").write_text(variant_source(src, VARIANTS[name]))
            GM.SOURCES[lname] = tmp / f"{name}.cu"
        for name, lname in variants8.items():
            (tmp / f"i8_{name}.cu").write_text(variant_source(src8, VARIANTS_I8[name], PATCHES_I8))
            GM.SOURCES[lname] = tmp / f"i8_{name}.cu"
        if args.against:
            variants["against"] = "ablation_against"
            variants.setdefault("full", "groupmin_wgmma")
            GM.SOURCES["ablation_against"] = args.against.resolve()
        if args.against_i8:
            variants8["against"] = "ablation_i8_against"
            variants8.setdefault("full", "groupmin_wgmma_i8")
            GM.SOURCES["ablation_i8_against"] = args.against_i8.resolve()
        f32_libs = {"f32_full": "groupmin"}
        if args.against_f32:
            f32_libs["f32_against"] = "ablation_f32_against"
            GM.SOURCES["ablation_f32_against"] = args.against_f32.resolve()
        t0 = time.perf_counter()
        libs = GM.build_all((*f32_libs.values(), *variants.values(), *variants8.values()))
        print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        for lname in (*variants.values(), *variants8.values()):
            if spills(GM.build_log.get(lname, "")):
                print(f"[build] {lname} spills registers: {spills(GM.build_log[lname])}", flush=True)
        last[0] = time.time()
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        call_args = [p, p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_float, p, i64, p]
        entries = {}
        for name, lname in variants.items():
            lib = ctypes.CDLL(str(libs[lname]))
            for tier, entry in ENTRIES.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = call_args, ctypes.c_int
                entries[name, tier] = fn
            sb = lib.tk_groupmin_wgmma_scratch_bytes
            sb.argtypes, sb.restype = [i64, ctypes.c_int, ctypes.c_int], i64
            entries[name, "scratch_bytes"] = sb
        for name, lname in variants8.items():
            lib = ctypes.CDLL(str(libs[lname]))
            fn = lib.tk_groupmin_i8
            fn.argtypes, fn.restype = call_args, ctypes.c_int
            entries["i8_" + name, "int8"] = fn
            sb = lib.tk_groupmin_i8_scratch_bytes
            sb.argtypes, sb.restype = [i64, ctypes.c_int], i64
            entries["i8_" + name, "scratch_bytes"] = lambda nq, d, _x3, sb=sb: sb(nq, d)
        for name, lname in f32_libs.items():
            fn = ctypes.CDLL(str(libs[lname])).tk_groupmin_f32
            fn.argtypes, fn.restype = call_args[:9] + [p], ctypes.c_int
            entries[name, "float32"] = fn
        if args.only not in ("int8", "against"):
            _run(entries, args.reps, last, torch, GM)
        if args.only not in ("wgmma", "against"):
            _run_i8(entries, args.reps, last, torch, GM)
        if args.against:
            _against(entries, args.reps, last, torch, args.against, dims, list(ENTRIES), "full", "against", _inputs)
        if args.against_i8:
            _against(entries, args.reps, last, torch, args.against_i8, dims, ["int8"], "i8_full", "i8_against",
                     _inputs_i8)
        if args.against_f32:
            _against(entries, args.reps, last, torch, args.against_f32, dims, ["float32"], "f32_full", "f32_against",
                     _inputs)
    print(_smi("name,power.limit"), flush=True)
    return 0


def _caller(entries, torch, name, tier, q, x, qt, xt, out):
    """One launch of a variant's entry, with its own scratch (the f32 entry takes none)."""
    if tier == "float32":
        def call_f32():
            err = entries[name, tier](q.data_ptr(), x.data_ptr(), qt.data_ptr(), xt.data_ptr(), out.data_ptr(),
                                      q.shape[0], x.shape[0], q.shape[1], -2.0,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} {tier}: launch failed ({err})")
        return call_f32
    nbytes = entries[name, "scratch_bytes"](q.shape[0], q.shape[1], int(tier == "high"))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def call():
        err = entries[name, tier](
            q.data_ptr(), x.data_ptr(), qt.data_ptr(), xt.data_ptr(), out.data_ptr(), q.shape[0],
            x.shape[0], q.shape[1], -2.0, scratch.data_ptr(), scratch.numel(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} {tier}: launch failed ({err})")
    return call


def _inputs_i8(nq, n, d, seed):
    """Uniform random int8 rows and non-integer row terms."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (n, d), dtype=torch.int8, device=dev, generator=gen)
    q = torch.randint(-128, 128, (nq, d), dtype=torch.int8, device=dev, generator=gen)
    return q, x, torch.rand(nq, device=dev, generator=gen) * 2e6, torch.rand(n, device=dev, generator=gen) * 2e6


def _against(entries, reps, last, torch, other, dims, tiers, full, against, inputs) -> None:
    for d in dims:
        q, x, qt, xt = inputs(2048, 1_007_616, d, seed=d)
        out = torch.empty(q.shape[0], x.shape[0] // 128, device="cuda")
        out2 = torch.empty_like(out)
        for tier in tiers:
            mine = _caller(entries, torch, full, tier, q, x, qt, xt, out)
            theirs = _caller(entries, torch, against, tier, q, x, qt, xt, out2)
            mine(), theirs()
            torch.cuda.synchronize()
            same = torch.equal(out, out2)
            ratios, tm, to = [], [], []
            for _ in range(reps):
                t = [_cuda_ms(mine, 5), _cuda_ms(theirs, 5), _cuda_ms(theirs, 5), _cuda_ms(mine, 5)]
                tm += [t[0], t[3]]
                to += [t[1], t[2]]
                ratios.append((t[1] + t[2]) / (t[0] + t[3]))
                last[0] = time.time()
            print(f"[against] {tier} Q=2048 N=1007616 D={d}: shipped median {statistics.median(tm):.3f} ms, "
                  f"{other.name} {statistics.median(to):.3f} ms; other / shipped: median "
                  f"{statistics.median(ratios):.3f} (least {min(ratios):.3f}, largest {max(ratios):.3f}); "
                  f"outputs equal {same}", flush=True)
        del q, x, qt, xt, out, out2


def _rounds(full, call, reps, n, last):
    """``reps`` rounds of (full, variant, variant, full), ``n`` launches a
    turn: (times of full, times of the variant, per-round ratios)."""
    fulls, times, ratios = [], [], []
    for _ in range(reps):
        t = [_cuda_ms(full, n), _cuda_ms(call, n), _cuda_ms(call, n), _cuda_ms(full, n)]
        fulls += [t[0], t[3]]
        times += [t[1], t[2]]
        ratios.append((t[1] + t[2]) / (t[0] + t[3]))
        last[0] = time.time()
    return fulls, times, ratios


def _sample_clocks(call, torch, last):
    """nvidia-smi's SM clock and power, every 0.2 s while ``call`` runs back to back for 3 s."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(_smi("clocks.sm,clocks.max.sm,power.draw,clocks_throttle_reasons.active"))
            time.sleep(0.2)
    th = threading.Thread(target=sample)
    t_end = time.time() + 3.0
    th.start()
    while time.time() < t_end:
        for _ in range(50):
            call()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    last[0] = time.time()
    return " | ".join(samples)


def _run_i8(entries, reps, last, torch, GM) -> None:
    """The int8 kernel's variants at the 1M x 128 l2sqr_sift shape, its
    clocks, and its other layouts at wider D."""
    nq, n = 2048, 1_007_616
    q, x, qt, xt = _inputs_i8(nq, n, 128, seed=0)
    out = torch.empty(nq, n // 128, device="cuda")
    ref = GM.fused_groupmin_reference(q, x, qt, xt, -2.0)
    names = [k[0][3:] for k in entries if k[0].startswith("i8_") and k[1] == "int8" and k[0] != "i8_against"]
    for name in names:
        if name in EXACT_I8:
            out.zero_()
            _caller(entries, torch, "i8_" + name, "int8", q, x, qt, xt, out)()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"int8 {name}: {int((out != ref).sum())} of {out.numel()} entries differ "
                                   f"from the plain version")
            last[0] = time.time()
    bound = 2.0 * nq * n * 128 / 1979e12 * 1e3
    print(f"[ablation] int8 Q={nq} N={n} D=128 scale -2, {reps} rounds of (full, variant, variant, full): "
          f"{', '.join(v for v in names if v in EXACT_I8)} bit-equal to plain; bound {bound:.3f} ms", flush=True)
    full = _caller(entries, torch, "i8_full", "int8", q, x, qt, xt, out)
    for name in names[1:]:
        call = _caller(entries, torch, "i8_" + name, "int8", q, x, qt, xt, out)
        try:
            fulls, times, ratios = _rounds(full, call, reps, 10, last)
        except Exception as e:
            raise RuntimeError(f"variant {name} int8 failed") from e
        print(f"[ablation]   int8 {name}: median {statistics.median(times):.3f} ms (least "
              f"{min(times):.3f}, largest {max(times):.3f}), full {statistics.median(fulls):.3f} ms; "
              f"/ full: median {statistics.median(ratios):.3f} (least {min(ratios):.3f}, largest "
              f"{max(ratios):.3f})", flush=True)
    print("[ablation] clocks during the full int8 kernel (sm MHz, max sm MHz, W, event reasons): "
          + _sample_clocks(full, torch, last), flush=True)
    del q, x, qt, xt, out, ref
    for d in (256, 384, 640, 960):
        q, x, qt, xt = _inputs_i8(nq, n, d, seed=d)
        out = torch.empty(nq, n // 128, device="cuda")
        call = _caller(entries, torch, "i8_full", "int8", q, x, qt, xt, out)
        call()
        torch.cuda.synchronize()
        same = torch.equal(out, GM.fused_groupmin_reference(q, x, qt, xt, -2.0))
        t = [_cuda_ms(call, 5) for _ in range(3)]
        last[0] = time.time()
        bound = 2.0 * nq * n * d / 1979e12 * 1e3
        print(f"[ablation] int8 Q={nq} N={n} D={d}: bit-equal to plain {same}; "
              + ", ".join(f"{v:.3f}" for v in t) + f" ms; bound {bound:.3f} ms, {bound / min(t):.1%} of it",
              flush=True)
        if not same:
            raise RuntimeError(f"int8 at D={d} differs from its plain version")
        del q, x, qt, xt, out


def _run(entries, reps, last, torch, GM) -> None:
    def caller(name, tier, q, x, qt, xt, out):
        return _caller(entries, torch, name, tier, q, x, qt, xt, out)

    def check(tier, q, x, qt, xt, out):
        caller("full", tier, q, x, qt, xt, out)()
        torch.cuda.synchronize()
        ref = GM.fused_groupmin_reference(q, x, qt, xt, -2.0, precision=tier)
        rel = float(((out.double() - ref.double()).abs() / _magnitude(q, x, qt, xt, -2.0)).max())
        if not rel <= 1e-5:
            raise RuntimeError(f"full {tier} at D={q.shape[1]}: {rel} of the magnitude from its plain version")
        return rel

    q, x, qt, xt = _inputs(2048, 1_007_616, 128, seed=0)
    out = torch.empty(q.shape[0], x.shape[0] // 128, device="cuda")
    names = list(VARIANTS)
    for tier in ENTRIES:
        rel = check(tier, q, x, qt, xt, out)
        f32 = _cuda_ms(lambda: GM.fused_groupmin(q, x, qt, xt, -2.0), 10)
        print(f"[ablation] {tier} Q=2048 N=1007616 D=128, {reps} rounds of (full, variant, variant, "
              f"full): full within {rel:.3g} of the magnitude of plain; f32 kernel {f32:.3f} ms", flush=True)
        full = caller("full", tier, q, x, qt, xt, out)
        for name in names[1:]:
            call = caller(name, tier, q, x, qt, xt, out)
            try:
                fulls, times, ratios = _rounds(full, call, reps, 10, last)
            except Exception as e:
                raise RuntimeError(f"variant {name} {tier} failed") from e
            print(f"[ablation]   {tier} {name}: median {statistics.median(times):.3f} ms (least "
                  f"{min(times):.3f}, largest {max(times):.3f}), full {statistics.median(fulls):.3f} ms; "
                  f"/ full: median {statistics.median(ratios):.3f} (least {min(ratios):.3f}, largest "
                  f"{max(ratios):.3f})", flush=True)

    # clocks under load: the full bf16 kernel back to back while nvidia-smi samples
    call = caller("full", "bfloat16", q, x, qt, xt, out)
    print("[ablation] clocks during the full bf16 kernel (sm MHz, max sm MHz, W, event reasons): "
          + _sample_clocks(call, torch, last), flush=True)
    del q, x, qt, xt, out

    # gist-960's width: the K-chunk path, in turns with the f32 kernel
    q, x, qt, xt = _inputs(1000, 1_000_064, 960, seed=1)
    out = torch.empty(q.shape[0], x.shape[0] // 128, device="cuda")
    for tier in ENTRIES:
        rel = check(tier, q, x, qt, xt, out)
        call = caller("full", tier, q, x, qt, xt, out)
        f32 = lambda: GM.fused_groupmin(q, x, qt, xt, -2.0)  # noqa: E731
        t = [_cuda_ms(f32, 3), _cuda_ms(call, 3), _cuda_ms(call, 3), _cuda_ms(f32, 3)]
        last[0] = time.time()
        print(f"[ablation] {tier} Q=1000 N=1000064 D=960 (K chunks): within {rel:.3g} of the magnitude of "
              f"plain; f32 {t[0]:.3f} ms, {tier} {t[1]:.3f}, {t[2]:.3f} ms, f32 {t[3]:.3f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
