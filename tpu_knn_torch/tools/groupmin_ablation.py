"""Ablation of the wgmma group-min kernel (``csrc/groupmin_wgmma.cu``) on
one CUDA card: which part of the kernel its time goes to.

Run from the root of a checkout::

    python3 -m tpu_knn_torch.tools.groupmin_ablation [--reps 12] [--against OTHER.cu [--dims 128,256]]

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
  half_mma    only every second k-step's products are issued;
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
where the kernel runs in K chunks. With ``--against``, another version of
the source (same entry points) is built beside it and both are timed in
turns (shipped, other, other, shipped) at each D of ``--dims`` (default
128, 256, 384, 960; Q=2048, N=1,007,616). Prints the card's name and power limit. Needs torch with CUDA and nvcc; imports neither jax nor tpu_knn.
"""

from __future__ import annotations

import argparse
import ctypes
import os
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


def variant_source(src: str, parts) -> str:
    """``src`` with each named part switched off; raises if a part's text
    is not in the source exactly once (the kernel changed under it)."""
    for part in parts:
        old, new = PATCHES[part]
        if src.count(old) != 1:
            raise RuntimeError(f"ablation part {part!r}: {old.strip()!r} is not in the kernel source once")
        src = src.replace(old, new)
    return src


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
    ap.add_argument("--against", type=Path, help="another groupmin_wgmma.cu to time beside the shipped one")
    ap.add_argument("--dims", default="128,256,384,960", help="widths of the --against comparison")
    args = ap.parse_args(argv)
    import torch

    from tpu_knn_torch.ops import groupmin as GM

    if not torch.cuda.is_available():
        print("groupmin_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    last = [time.time()]
    _watchdog(last, 120.0)
    src = GM.SOURCES["groupmin_wgmma"].read_text()
    with tempfile.TemporaryDirectory(prefix="groupmin_ablation_") as tmp_dir:
        tmp = Path(tmp_dir)
        GM.BUILD_DIR = tmp
        variants = dict(VARIANTS)
        for name, parts in VARIANTS.items():
            (tmp / f"{name}.cu").write_text(variant_source(src, parts))
            GM.SOURCES[f"ablation_{name}"] = tmp / f"{name}.cu"
        if args.against:
            variants["against"] = ()
            GM.SOURCES["ablation_against"] = args.against.resolve()
        t0 = time.perf_counter()
        libs = GM.build_all(("groupmin", *(f"ablation_{n}" for n in variants)))
        print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        last[0] = time.time()
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        entries = {}
        for name in variants:
            lib = ctypes.CDLL(str(libs[f"ablation_{name}"]))
            for tier, entry in ENTRIES.items():
                fn = getattr(lib, entry)
                fn.argtypes = [p, p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_float, p, i64, p]
                fn.restype = ctypes.c_int
                entries[name, tier] = fn
            sb = lib.tk_groupmin_wgmma_scratch_bytes
            sb.argtypes, sb.restype = [i64, ctypes.c_int, ctypes.c_int], i64
            entries[name, "scratch_bytes"] = sb
        _run(entries, args.reps, last, torch, GM)
        if args.against:
            _against(entries, args.reps, last, torch, args.against, [int(v) for v in args.dims.split(",")])
    print(_smi("name,power.limit"), flush=True)
    return 0


def _caller(entries, torch, name, tier, q, x, qt, xt, out):
    """One launch of a variant's entry, with its own scratch."""
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


def _against(entries, reps, last, torch, other, dims) -> None:
    for d in dims:
        q, x, qt, xt = _inputs(2048, 1_007_616, d, seed=d)
        out = torch.empty(q.shape[0], x.shape[0] // 128, device="cuda")
        for tier in ENTRIES:
            mine = _caller(entries, torch, "full", tier, q, x, qt, xt, out)
            theirs = _caller(entries, torch, "against", tier, q, x, qt, xt, out)
            ratios, tm, to = [], [], []
            for _ in range(reps):
                t = [_cuda_ms(mine, 5), _cuda_ms(theirs, 5), _cuda_ms(theirs, 5), _cuda_ms(mine, 5)]
                tm += [t[0], t[3]]
                to += [t[1], t[2]]
                ratios.append((t[1] + t[2]) / (t[0] + t[3]))
                last[0] = time.time()
            print(f"[against] {tier} Q=2048 N=1007616 D={d}: shipped median {statistics.median(tm):.3f} ms, "
                  f"{other.name} {statistics.median(to):.3f} ms; other / shipped: median "
                  f"{statistics.median(ratios):.3f} (least {min(ratios):.3f}, largest {max(ratios):.3f})",
                  flush=True)
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
            fulls, times, ratios = [], [], []
            try:
                for _ in range(reps):
                    t = [_cuda_ms(full, 10), _cuda_ms(call, 10), _cuda_ms(call, 10), _cuda_ms(full, 10)]
                    fulls += [t[0], t[3]]
                    times += [t[1], t[2]]
                    ratios.append((t[1] + t[2]) / (t[0] + t[3]))
                    last[0] = time.time()
            except Exception as e:
                raise RuntimeError(f"variant {name} {tier} failed") from e
            print(f"[ablation]   {tier} {name}: median {statistics.median(times):.3f} ms (least "
                  f"{min(times):.3f}, largest {max(times):.3f}), full {statistics.median(fulls):.3f} ms; "
                  f"/ full: median {statistics.median(ratios):.3f} (least {min(ratios):.3f}, largest "
                  f"{max(ratios):.3f})", flush=True)

    # clocks under load: the full bf16 kernel back to back while nvidia-smi samples
    call = caller("full", "bfloat16", q, x, qt, xt, out)
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
    print(f"[ablation] clocks during the full bf16 kernel (sm MHz, max sm MHz, W, event reasons): "
          + " | ".join(samples), flush=True)
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
