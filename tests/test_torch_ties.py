"""Tie order of the port's f32 sums (ROADMAP.md section 3), dense spaces:
the re-anchor probe replayed on the CPU against tpu_knn.

The port keeps its own f32 summation order by design: on the card the
order can never be XLA's, so matching XLA's CPU order would only make the
CPU agree. On tie-heavy data (integer rows) exactly tied candidates then
reorder, and graphs built through the int8 construction store differ from
tpu_knn's in a few rows. These tests pin what that costs: tie-aware
recall@10 at efSearch=20 within 0.005 of tpu_knn's (a returned id is a hit
when its float64 distance is at most the true 10th distance), and level-0
neighbour sets equal in every row wherever the probe found them equal
(constructionStore=0 on l2 / l1 / negdotprod, and continuous rows)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.eval.datasets import clustered  # noqa: E402

CPU = {"device": "cpu"}
BUILD = dict(M=8, efConstruction=40, waveSize=128, seed=0)
MARGIN = 0.005


def _rows(n):
    return np.random.default_rng(3).integers(0, 4, (n, 16)).astype(np.float32)


QUERIES = np.random.default_rng(4).integers(0, 4, (200, 16)).astype(np.float32)


def _f64(space, q, x):
    """Float64 distances [Q, N] of the reference formulas."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    if space == "l2":
        return np.sqrt(((q[:, None] - x[None]) ** 2).sum(-1))
    if space == "l1":
        return np.abs(q[:, None] - x[None]).sum(-1)
    if space == "negdotprod":
        return -(q @ x.T)
    qn, xn = np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1)
    cos = (q @ x.T) / np.maximum(qn[:, None] * xn[None], 1e-300)
    return 1.0 - np.where((qn[:, None] > 0) & (xn[None] > 0), cos, 0.0)


@functools.lru_cache(maxsize=None)
def _built(space, n, store, continuous=False):
    """(tpu_knn index, port index) over the same rows, built alike."""
    x = clustered(n, 16, n_clusters=20, seed=5) if continuous else _rows(n)
    out = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, CPU)):
        idx = pkg.Index(space, pkg.Params(dim=16), **kw)
        idx.add_dense_batch(x)
        idx.build_index(pkg.Params(dict(BUILD, constructionStore=int(store))))
        idx.set_query_time_params(pkg.Params(efSearch=20))
        out.append(idx)
    return x, out


def _tie_recall(space, x, ids, k=10):
    d = _f64(space, QUERIES, x)
    kth = np.sort(d, axis=1)[:, k - 1:k]
    got = np.take_along_axis(d, np.clip(ids, 0, None), axis=1)
    return float(np.mean(np.where(ids >= 0, got <= kth + 1e-9 * np.abs(kth), False)))


def _level0_sets(idx):
    g = idx.method.graph["level0"]
    return np.sort(g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g), axis=1)


@pytest.mark.parametrize("space", ["l2", "l1", "negdotprod", "cosinesimil"])
def test_tie_aware_recall_within_margin(space):
    """2000 integer rows, the default construction store: recall@10 within
    0.005 of tpu_knn's (the probe: 0.9812 against 0.9820 for l2, 0.9656
    against 0.9688 for l1)."""
    x, (a, b) = _built(space, 2000, True)
    ra = _tie_recall(space, x, a.knn_query_batch(QUERIES, 10)[1])
    rb = _tie_recall(space, x, b.knn_query_batch(QUERIES, 10)[1])
    assert abs(ra - rb) <= MARGIN, (space, ra, rb)
    assert rb >= 0.9


@pytest.mark.parametrize("space", ["l2", "l1", "negdotprod"])
def test_level0_sets_equal_without_the_store(space):
    """constructionStore=0: the plain scores tie alike in both packages on
    integer rows, so every row's neighbour set is tpu_knn's."""
    _, (a, b) = _built(space, 1000, False)
    np.testing.assert_array_equal(_level0_sets(b), _level0_sets(a))


@pytest.mark.parametrize("space", ["l2", "l1"])
def test_level0_sets_equal_on_continuous_rows(space):
    """With the store on (the default) and continuous rows, nothing ties."""
    _, (a, b) = _built(space, 1000, True, continuous=True)
    np.testing.assert_array_equal(_level0_sets(b), _level0_sets(a))
