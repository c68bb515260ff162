"""Shared pieces of the benchmark's own tests: tiny cells for the CPU, and
the ``card`` marker for tests that need an NVIDIA card (they skip without
one, decided inside the test)."""

import copy

import pytest
import torch

from knnbench.registry import load_cell

#: the sizes a CPU test run holds; a dense corpus keeps the cell's two-pass
#: route, which needs n_pad >= 8 (k + 2) 128 (methods/seq_search.py _plan_knn)
TINY = {"dense_vector": 16384, "sparse_vector": 3000}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def tiny_cell(name: str, root=None, k: int | None = None):
    """A cell of BENCHMARK.json at a size the CPU holds: a small corpus, a pool
    of 2 batches of 32 queries."""
    cell = load_cell(name) if root is None else load_cell(name, root)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if k is not None:
        tr["k"] = k
    cfg["n"] = TINY[cfg["data_type"]]
    if cfg["generator"]["recipe"] == "sift_like":
        cfg["generator"]["clusters"] = 64
        cfg["n"] = max(cfg["n"], 8 * (int(tr.get("k", 10)) + 2) * 128)
    tr["batch"], tr["pool_batches"], tr["warmup_rounds"] = 32, 2, 1
    cell.config, cell.traffic = cfg, tr
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
