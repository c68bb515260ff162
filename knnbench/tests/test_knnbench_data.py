"""The generators: the same seed gives the same inputs, another seed others."""

import numpy as np
import pytest

from knnbench.data import make_inputs

from .conftest import tiny_cell

CELLS = ["sift128-l2-knn10-b2048", "splade1m-ip-knn10-b2048"]


def _arrays(inp):
    parts = [inp.ids]
    for x in (inp.corpus, inp.queries):
        parts.extend(x if isinstance(x, tuple) else (x,))
    return parts


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    cell = tiny_cell(name)
    a = make_inputs(cell.config, cell.traffic, 2**33 + 7, "cpu")
    b = make_inputs(cell.config, cell.traffic, 2**33 + 7, "cpu")
    c = make_inputs(cell.config, cell.traffic, 2**33 + 8, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    assert not np.array_equal(_arrays(a)[1], _arrays(c)[1])


@pytest.mark.parametrize("name", CELLS)
def test_inputs_shape(name):
    cell = tiny_cell(name)
    inp = make_inputs(cell.config, cell.traffic, 5, "cpu")
    n, nq = cell.config["n"], cell.traffic["batch"] * cell.traffic["pool_batches"]
    assert sorted(inp.ids.tolist()) == list(range(n))
    if inp.kind == "dense":
        assert inp.corpus.shape == (n, cell.config["dim"]) and inp.queries.shape[0] == nq
        assert inp.corpus.min() >= 0 and inp.corpus.max() <= 255
        return
    for (indptr, ids, vals), rows in ((inp.corpus, n), (inp.queries, nq)):
        assert len(indptr) == rows + 1 and indptr[-1] == len(ids) == len(vals)
        for r in range(0, rows, max(1, rows // 50)):  # ascending distinct terms in every row
            row = ids[indptr[r]:indptr[r + 1]]
            assert len(row) and (np.diff(row) > 0).all() and row.max() < cell.config["vocab"]
    batch = inp.api_batch(1)
    assert len(batch) == cell.traffic["batch"] and batch[0][0].dtype == np.int32 and batch[0][0].min() >= 1
