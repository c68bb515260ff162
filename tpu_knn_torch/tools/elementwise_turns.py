"""The elementwise kernel (csrc/groupmin_elementwise.cu) of one checkout,
timed at 2048 queries x 65,536 rows x 128 on one CUDA card (or, with
``--batched``, its batched epilogue at the shapes of pass 2 and of the HNSW
build's pairs), to compare two checkouts on one machine; and the SASS of two
builds of it, instance by instance.

Run it by path, with the checkout under test first on the module path, in
turns (parent, change, change, parent):

    PYTHONPATH=<other checkout> python3 tpu_knn_torch/tools/elementwise_turns.py --label parent
    PYTHONPATH=. python3 tpu_knn_torch/tools/elementwise_turns.py --label change

Each run builds that checkout's library and prints its path, then the mean
device ms (CUDA events, ``--reps`` launches after a warm-up) of both
epilogues of l1, linf, lp at p=3 and p=0.7 and js: uniform rows in [0, 100)
for the first three, Dirichlet(0.1) histograms for js, the last 128 rows
padded, with the card's name and power limit. With ``--batched`` it times
``elementwise_batched`` at each of ``BATCHED``: B batch items of Cq queries
against K rows of D = 128 each, the rows and queries gathered by seeded ids
from 200,000 such rows (pass 2 at Cq = 1 with its 1536 rows; the
construction heuristic's pairs at 100 and 108, the reverse shrink's at 40 and
24). The tool runs against any checkout whose ``elementwise_batched`` takes
(form, q, rows, pad, p). With ``--scaling`` it times the pair kernel of l1
and js at B x C = 1024 x 108, 4096 x 108 and 16384 x 40 for D = 128, 256,
512 and 1024 (uniform rows; each with its element pairs a second,
B x C x C x D over the time), to tell costs a block from costs a column,
then samples the SM clock, power and temperature while l1 at 1024 x 108 x
108 runs for 3 s. Then

    python3 tpu_knn_torch/tools/elementwise_turns.py --sass LIB_A LIB_B

prints, for every kernel instance in both libraries (matched by form, LP
power and epilogue, whatever the template signature: the group-min and
distance epilogues, the batched epilogue's kernel at Cq = 1 ("gathered"), its
pair kernel and the reduce-scatter kernel it replaced), the instruction counts and how
many instructions differ once branch targets are masked.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

import numpy as np

#: form, p: the rows each run times
CASES = (("l1", None), ("linf", None), ("lp", 3.0), ("lp", 0.7), ("js", None))
ROWS, QUERIES, DIM = 65_536, 2048, 128
#: the batched shapes: form, p, B, Cq, K
BATCHED = (("l1", None, 1024, 1, 1536), ("js", None, 1024, 1, 1536), ("l1", None, 1024, 100, 100),
           ("l1", None, 1024, 108, 108), ("l1", None, 16384, 40, 40), ("l1", None, 16384, 24, 24),
           ("linf", None, 1024, 108, 108), ("lp", 3.0, 1024, 108, 108), ("lp", 0.7, 1024, 108, 108),
           ("js", None, 1024, 108, 108))
BATCHED_ROWS = 200_000
_KERNEL = re.compile(r"groupmin_elementwise_kernelILi(\d)E(?:Li(\d+)E)?Lb(\d)E")
#: the batched epilogue's kernels: ``elementwise_batched_kernel<F, P, QG>`` (QG 1 at Cq = 1; QG 32,
#: the reduce-scatter at Cq > 1, before the pair kernel), ``elementwise_pair_kernel<F, P>``
_BATCHED = re.compile(r"elementwise_(batched|pair)_kernelILi(\d)ELi(\d+)E(?:Li(\d+)E)?")


def _cuda_ms(fn, reps: int) -> float:
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


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def time_checkout(label: str, reps: int) -> None:
    import torch

    from tpu_knn_torch.ops import elementwise as EW
    from tpu_knn_torch.ops import groupmin as GM

    print(f"[elementwise] {label} lib {GM.build_all((EW.LIB,))[EW.LIB]}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n = ROWS + QUERIES
    uniform = torch.from_numpy(rng.random((n, DIM), dtype=np.float32) * 100).to(dev)
    g = rng.standard_gamma(0.1, size=(n, DIM)).astype(np.float32)
    hist = torch.from_numpy(g / g.sum(axis=1, keepdims=True)).to(dev)
    pad = torch.zeros(ROWS, device=dev)
    pad[-128:] = 1e30
    out = {}
    for form, p in CASES:
        src = hist if form == "js" else uniform
        q, x = src[ROWS:].contiguous(), src[:ROWS].contiguous()
        for epi, fn in (("groupmin", EW.elementwise_groupmin), ("dists", EW.elementwise_dists)):
            out[f"{form} p={p} {epi}"] = _cuda_ms(lambda: fn(form, q, x, pad, p), reps)
    print(f"[elementwise] {label} ms {json.dumps(out)}; {_smi()}", flush=True)


def time_batched(label: str, reps: int) -> None:
    import torch

    from tpu_knn_torch.ops import elementwise as EW
    from tpu_knn_torch.ops import groupmin as GM

    print(f"[elementwise] {label} lib {GM.build_all((EW.LIB,))[EW.LIB]}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    uniform = torch.from_numpy(rng.random((BATCHED_ROWS, DIM), dtype=np.float32) * 100).to(dev)
    g = rng.standard_gamma(0.1, size=(BATCHED_ROWS, DIM)).astype(np.float32)
    hist = torch.from_numpy(g / g.sum(axis=1, keepdims=True)).to(dev)
    out = {}
    for form, p, nb, cq, k in BATCHED:
        src = hist if form == "js" else uniform
        qi = torch.from_numpy(rng.integers(0, BATCHED_ROWS, (nb, cq))).to(dev)
        ri = torch.from_numpy(rng.integers(0, BATCHED_ROWS, (nb, k))).to(dev)
        q, rows = src[qi], src[ri]
        pad = torch.zeros(nb, k, device=dev)
        pad[-1, -8:] = 1e30
        out[f"{form} p={p} {nb}x{cq}x{k}"] = _cuda_ms(lambda: EW.elementwise_batched(form, q, rows, pad, p), reps)
        del q, rows, pad
    print(f"[elementwise] {label} batched ms {json.dumps(out)}; {_smi()}", flush=True)


def time_scaling(reps: int) -> None:
    import threading
    import time

    import torch

    from tpu_knn_torch.ops import elementwise as EW
    from tpu_knn_torch.ops import groupmin as GM

    GM.build_all((EW.LIB,))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def tensors(nb, c, d):
        q, r = (torch.from_numpy(rng.random((nb, c, d), dtype=np.float32) * 100).to(dev) for _ in range(2))
        return q, r, torch.zeros(nb, c, device=dev)

    for form in ("l1", "js"):
        for nb, c in ((1024, 108), (4096, 108), (16384, 40)):
            row = []
            for d in (128, 256, 512, 1024):
                q, r, pad = tensors(nb, c, d)
                ms = _cuda_ms(lambda: EW.elementwise_batched(form, q, r, pad), reps)
                row.append((d, round(ms, 4), round(nb * c * c * d / ms / 1e9, 3)))
                del q, r, pad
            print(f"[scaling] {form} B={nb} C={c} (D, ms, T element pairs a second): {row}; {_smi()}", flush=True)
    q, r, pad = tensors(1024, 108, DIM)
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
            time.sleep(0.2)

    th = threading.Thread(target=sample)
    th.start()
    t0, n = time.time(), 0
    while time.time() - t0 < 3.0:
        for _ in range(50):
            EW.elementwise_batched("l1", q, r, pad)
        torch.cuda.synchronize()
        n += 50
    stop.set()
    th.join()
    print(f"[scaling] l1 1024 x 108 x 108 for 3 s ({n} launches): clocks.sm, power, temperature {samples[1:]}; "
          f"{_smi()}", flush=True)


def _sass_key(name: str):
    """(form, power, epilogue) of a kernel instance's mangled name, or None."""
    k = _KERNEL.search(name)
    if k:
        return int(k.group(1)), int(k.group(2) or 0), "groupmin" if k.group(3) == "1" else "dists"
    b = _BATCHED.search(name)
    if not b:
        return None
    kind, last = b.group(1), b.group(4)
    if kind == "pair":
        return int(b.group(2)), int(b.group(3)), "pairs"
    return int(b.group(2)), int(b.group(3)), "gathered" if last == "1" else f"pairs QG {last}"


def _sass(lib: str) -> dict:
    """{(form, power, epilogue): [instruction text, branch targets masked]} of a library."""
    exe = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    txt = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for ln in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            key = _sass_key(m.group(1))
            cur = out.setdefault(key, []) if key else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if cur is not None and m:
            cur.append(re.sub(r"0x[0-9a-f]+|`\(\.L_x_\d+\)", "T", m.group(1)))
    return out


def compare_sass(lib_a: str, lib_b: str) -> None:
    a, b = _sass(lib_a), _sass(lib_b)
    for key in sorted(set(a) & set(b)):
        ia, ib = a[key], b[key]
        diff = sum(u != v for u, v in zip(ia, ib)) + abs(len(ia) - len(ib))
        print(f"[elementwise] sass form {key[0]} power {key[1]} {key[2]}: {len(ia)} instructions, "
              f"against {len(ib)}; {diff} differ", flush=True)
    for key in sorted(set(a) ^ set(b)):
        print(f"[elementwise] sass form {key[0]} power {key[1]} {key[2]}: only in "
              f"{lib_a if key in a else lib_b}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", nargs=2, metavar="LIB")
    ap.add_argument("--batched", action="store_true", help="the batched epilogue at BATCHED's shapes")
    ap.add_argument("--scaling", action="store_true", help="the pair kernel against D and B, and the SM clock")
    args = ap.parse_args()
    if args.sass:
        compare_sass(*args.sass)
    elif args.batched:
        time_batched(args.label, args.reps)
    elif args.scaling:
        time_scaling(args.reps)
    else:
        time_checkout(args.label, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
