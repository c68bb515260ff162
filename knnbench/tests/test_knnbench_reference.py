"""The reference against a brute-force top-k, and the comparison's numbers
for a sound answer and for the control."""

import json

import numpy as np
import pytest
import torch

from knnbench.control import control_numbers
from knnbench.data import make_inputs
from knnbench.reference import Reference, tf32

from .conftest import tiny_cell

KNN_CELLS = ["sift128-l2-knn10-b2048", "splade1m-ip-knn10-b2048", "sift128-l2-knn100-b2048"]
ALL_CELLS = KNN_CELLS + ["sift128-l2-range-b2048"]


def _brute(inp, space):
    """float64 distances [pool, n] by numpy, one pair at a time in spirit."""
    if space == "l2":
        q, x = inp.queries.astype(np.float64), inp.corpus.astype(np.float64)
        return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    def dense(csr, rows):
        indptr, ids, vals = csr
        out = np.zeros((rows, inp.vocab))
        for r in range(rows):
            out[r, ids[indptr[r]:indptr[r + 1]]] = vals[indptr[r]:indptr[r + 1]]
        return out
    return -(dense(inp.queries, inp.batch * inp.pool) @ dense(inp.corpus, inp.n).T)


@pytest.mark.parametrize("name", ["sift128-l2-knn10-b2048", "splade1m-ip-knn10-b2048"])
def test_reference_matches_brute_force(name):
    cell = tiny_cell(name)
    cell.config["n"] = 2000
    inp = make_inputs(cell.config, cell.traffic, 11, "cpu")
    ref = Reference(inp, cell.config["space"], "cpu")
    want = _brute(inp, cell.config["space"])
    got = torch.cat([ref.form.exact(s, e) for b in range(inp.pool) for s, e in ref._blocks(b)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9 * np.abs(want).max())
    k = 10
    np.testing.assert_allclose(np.sort(got, 1)[:, :k], np.sort(want, 1)[:, :k], rtol=1e-12, atol=1e-9)


def _perfect_answers(ref, inp, k):
    """What a float64 scan answers, as the program would return it (f32)."""
    out = {}
    for b in range(inp.pool):
        ds, ids = [], []
        for s, e in ref._blocks(b):
            v, pos = torch.topk(ref.form.exact(s, e), k, dim=1, largest=False)
            d = v.sqrt() if inp.kind == "dense" else v
            ds.append(d.float().numpy())
            ids.append(inp.ids[pos.numpy()].astype(np.int32))
        out[b] = [(np.concatenate(ds), np.concatenate(ids))]
    return out


@pytest.mark.parametrize("name", KNN_CELLS)
def test_exact_answers_read_zero_gap(name):
    cell = tiny_cell(name)
    inp = make_inputs(cell.config, cell.traffic, 12, "cpu")
    ref = Reference(inp, cell.config["space"], "cpu")
    k = int(cell.traffic["k"])
    got = ref.knn(_perfect_answers(ref, inp, k), k)
    assert got["rank_gap"] == 0.0 and got["dist_err"] < 0.05
    ans = _perfect_answers(ref, inp, k)
    d, ids = ans[0][0]
    ids = ids.copy()
    ids[3, 0] = ids[3, 1]  # a repeated id
    assert ref.knn({0: [(d, ids)]}, k)["rank_gap"] == float("inf")


@pytest.mark.parametrize("name", ALL_CELLS)
def test_control_fails(name):
    """The TF32 control, in the program's place, is not correct (at a size a
    test run holds; the card's readings at the cells' own size are in
    PERF.md)."""
    cell = tiny_cell(name)
    limits = json.loads((cell.root / "knnbench" / "limits" / f"{name}.json").read_text())
    for seed in (21, 22, 23):
        numbers = control_numbers(cell, seed, "cpu")
        assert any(v > limits[k] for k, v in numbers.items()), (seed, numbers, limits)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, 255.3, -0.1])
    t = tf32(x)
    assert t[:4].tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2**-9]
    assert ((t.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.allclose(t, x, rtol=2**-11)
