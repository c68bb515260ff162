"""The elementwise kernel (csrc/groupmin_elementwise.cu) of one checkout,
timed at 2048 queries x 65,536 rows x 128 on one CUDA card, to compare two
checkouts on one machine; and the SASS of two builds of it, instance by
instance.

Run it by path, with the checkout under test first on the module path, in
turns (parent, change, change, parent):

    PYTHONPATH=<other checkout> python3 tpu_knn_torch/tools/elementwise_turns.py --label parent
    PYTHONPATH=. python3 tpu_knn_torch/tools/elementwise_turns.py --label change

Each run builds that checkout's library and prints its path, then the mean
device ms (CUDA events, ``--reps`` launches after a warm-up) of both
epilogues of l1, linf, lp at p=3 and p=0.7 and js: uniform rows in [0, 100)
for the first three, Dirichlet(0.1) histograms for js, the last 128 rows
padded, with the card's name and power limit. Then

    python3 tpu_knn_torch/tools/elementwise_turns.py --sass LIB_A LIB_B

prints, for every kernel instance in both libraries (matched by form, LP
power and epilogue, whatever the template signature), the instruction
counts and how many instructions differ once branch targets are masked.
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
_KERNEL = re.compile(r"groupmin_elementwise_kernelILi(\d)E(?:Li(\d+)E)?Lb(\d)E")


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


def _sass(lib: str) -> dict:
    """{(form, power, groupmin): [instruction text, branch targets masked]} of a library."""
    exe = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    txt = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for ln in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            k = _KERNEL.search(m.group(1))
            cur = out.setdefault((int(k.group(1)), int(k.group(2) or 0), int(k.group(3))), []) if k else None
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
        print(f"[elementwise] sass form {key[0]} power {key[1]} groupmin {key[2]}: {len(ia)} instructions, "
              f"against {len(ib)}; {diff} differ", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", nargs=2, metavar="LIB")
    args = ap.parse_args()
    if args.sass:
        compare_sass(*args.sass)
    else:
        time_checkout(args.label, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
