"""The control of the comparison that decides ``correct``: the reference
computed at TF32, one precision below the configurations' IEEE float32,
put in the program's place for every batch of the cell's query pool, and
judged as a run judges the program. It has to come out not correct.

Not part of a benchmark run. Run on the card at a cell's own size:

    python -m knnbench.control --workload <cell> --seeds 11 12 13

It prints one JSON line a seed: the numbers compared and their limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .data import make_inputs
from .reference import Reference
from .registry import Cell, find, load_cell


def control_numbers(cell: Cell, seed: int, device) -> dict:
    """The control's numbers on one seed's inputs."""
    inputs = make_inputs(cell.config, cell.traffic, seed, device)
    kind = find("kinds", cell.traffic["kind"], cell.root)
    args = kind.prepare(cell, inputs, device)
    ref = Reference(inputs, cell.config["space"], device)
    return kind.exact(ref, kind.control(ref, cell.traffic, args), cell.traffic, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m knnbench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    limits = json.loads((cell.root / "knnbench" / "limits" / f"{cell.name}.json").read_text())
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control_numbers(cell, seed, device)
        failed = [k for k, v in numbers.items() if v > limits[k]]
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": numbers, "limits": limits,
                          "control_fails": bool(failed), "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
