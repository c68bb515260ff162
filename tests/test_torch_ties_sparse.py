"""Tie order of the port's f32 sums (ROADMAP.md section 3), sparse spaces:
the re-anchor probe replayed on the CPU against tpu_knn.

sparse_like(600, vocab=500, nnz=12, n_clusters=8, seed=1) takes few
distinct values (1 + log1p of a Poisson count), so f32 sums that run in
another order than XLA's (``score_rows``, ``_score_pairs``, ``block``) tie
candidates differently and sparse HNSW by exact waves (sketchDim=0, 500
rows) differs from tpu_knn's in a few level-0 rows for the five names
below. The port keeps its order by design (tests/test_torch_ties.py); this
pins the cost: tie-aware recall@10 at efSearch=20 within 0.005 of
tpu_knn's, a returned id counting as a hit when its float64 distance is at
most the true 10th distance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tpu_knn  # noqa: E402
import tpu_knn_torch  # noqa: E402
from tpu_knn_torch.eval.datasets import sparse_like  # noqa: E402

CPU = {"device": "cpu"}
MARGIN = 0.005
PTS = sparse_like(600, vocab=500, nnz=12, n_clusters=8, seed=1)


def _dense(pts):
    m = np.zeros((len(pts), 501), np.float64)
    for i, (ids, vals) in enumerate(pts):
        m[i, np.asarray(ids)] = np.asarray(vals, np.float64)
    return m


def _f64(space, q, x):
    """Float64 distances [Q, N] of the reference formulas (lp at p=3)."""
    if space in ("l1_sparse", "l2_sparse", "lp_sparse"):
        p = {"l1_sparse": 1.0, "l2_sparse": 2.0, "lp_sparse": 3.0}[space]
        return (np.abs(q[:, None] - x[None]) ** p).sum(-1) ** (1.0 / p)
    dot = q @ x.T
    if space == "negdotprod_sparse":
        return -dot
    qn = np.linalg.norm(q, axis=1)
    return -dot / np.maximum(qn[:, None], 1e-300)  # querynorm_negdotprod_sparse


@pytest.mark.parametrize("space", ["l1_sparse", "negdotprod_sparse", "l2_sparse", "querynorm_negdotprod_sparse",
                                   "lp_sparse"])
def test_sparse_tie_aware_recall_within_margin(space):
    corpus, queries = PTS[:500], PTS[500:]
    rec = []
    for pkg, kw in ((tpu_knn, {}), (tpu_knn_torch, CPU)):
        idx = pkg.Index(space, pkg.Params(p=3.0) if space == "lp_sparse" else None, data_type="sparse_vector", **kw)
        idx.add_sparse_batch(corpus)
        idx.build_index(pkg.Params(M=8, efConstruction=40, waveSize=128, seed=0, sketchDim=0))
        idx.set_query_time_params(pkg.Params(efSearch=20))
        ids = idx.knn_query_batch(queries, 10)[1] - 1  # sparse object ids are 1-based positions
        d = _f64(space, _dense(queries), _dense(corpus))
        kth = np.sort(d, axis=1)[:, 9:10]
        got = np.take_along_axis(d, np.clip(ids, 0, None), axis=1)
        rec.append(float(np.mean(np.where(ids >= 0, got <= kth + 1e-9 * np.abs(kth), False))))
    assert abs(rec[0] - rec[1]) <= MARGIN, (space, rec)
    assert rec[1] >= 0.8
