"""Importing tpu_knn_torch must load neither jax nor tpu_knn (the card's
machine has no jax), must not initialize CUDA and must build nothing."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

PKG = Path(__file__).resolve().parent.parent / "tpu_knn_torch"


def test_import_loads_no_jax_no_cuda_no_build():
    code = (
        "import os, sys, pkgutil, importlib\n"
        f"build = {str(PKG / '_build')!r}\n"
        "before = sorted(os.listdir(build)) if os.path.isdir(build) else None\n"
        "import torch, tpu_knn_torch\n"
        "for m in pkgutil.walk_packages(tpu_knn_torch.__path__, 'tpu_knn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tpu_knn' or m.startswith('tpu_knn.')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "after = sorted(os.listdir(build)) if os.path.isdir(build) else None\n"
        "assert before == after, (before, after)\n"
        "from tpu_knn_torch.ops import groupmin\n"
        "assert groupmin._libs == {} and set(groupmin.launches.values()) == {0}\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=str(PKG.parent))
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "clean" in r.stdout


def test_sources_never_import_jax_or_tpu_knn():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or s.startswith(("import tpu_knn.", "from tpu_knn.", "from tpu_knn "))
                        or s == "import tpu_knn"), f"{path}: {s}"
