"""The check that a run loads neither JAX nor the JAX package."""

import subprocess
import sys
import textwrap

from knnbench import hygiene
from knnbench.registry import ROOT


def test_top_level_names_compared_whole():
    bad = ["tpu_knn", "tpu_knn.ops.topk", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    good = ["tpu_knn_torch", "tpu_knn_torch.ops.topk", "jaxtyping", "tpu_knnx", "knnbench", "torch"]
    assert hygiene.forbidden(bad + good) == sorted(bad)


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run on the CPU, in a process of its own."""
    code = textwrap.dedent("""
        import sys, time, torch
        torch.set_num_threads(2)
        from knnbench.tests.conftest import tiny_cell
        from knnbench import hygiene
        from knnbench.harness import run_cell
        res, _ = run_cell(tiny_cell("sift128-l2-knn10-b2048"), 3, 0.3, False, "cpu", time.perf_counter())
        assert res["correct"], res
        print("FORBIDDEN", hygiene.forbidden())
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
