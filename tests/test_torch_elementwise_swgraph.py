"""l1, lp (p=3) and jsdivfast through sw-graph (the beam and score_rows through the batched
epilogue at one query a row, the heuristic's pairs at C, the wave mates through the distance
epilogue; on the CPU their plain versions) against tpu_knn: tests/test_torch_elementwise_methods.py's
check, in a file of its own so that it runs beside the others."""

import pytest

pytest.importorskip("torch")

from test_torch_elementwise_methods import NAMES, check_method  # noqa: E402


@pytest.mark.parametrize("name", sorted(NAMES))
def test_swgraph_matches_tpu_knn(name):
    check_method(name, "sw-graph")
