"""On the card (skip without one): a short run of each cell through the
command, and the control at the cells' own size. Run on a card with
``python -m pytest knnbench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from knnbench.registry import ROOT, load_spec

CELLS = [w["name"] for w in load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "knnbench", "--workload", name, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_full_size(card, name):
    out = subprocess.run([sys.executable, "-m", "knnbench.control", "--workload", name, "--seeds", "7", "8", "9"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in out.stdout.strip().splitlines():
        assert json.loads(line)["control_fails"], line
