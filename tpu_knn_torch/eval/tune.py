"""Auto-tuning (counterpart of tpu_knn/eval/tune.py; reference:
include/tune.h GetOptimalAlphas, src/searchoracle.cc
PolynomialPruner::SetIndexTimeParams tuning path).

The reference runs a recursive grid/step search over the VP-tree
pruner's alphaLeft/alphaRight to hit a desired recall with maximal
pruning. Here the same goal is met with a geometric sweep: sample
queries from the indexed data, compute the gold standard once, then walk
alpha upward (more pruning) while recall stays above the target, and
return the last passing setting."""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataKind, DataStore
from ..utils.logging import log
from ..utils.rng import np_rng
from .gold_standard import GoldStandard
from .metrics import per_query_metrics


def _query_points(store: DataStore, positions: np.ndarray):
    """The stored points at ``positions`` in the format knn takes
    (tpu_knn/eval/experiments.py _query_points)."""
    pts = [store.get_point(int(p)) for p in positions]
    if store.kind in (DataKind.DENSE, DataKind.UINT8):
        return np.stack(pts)
    return pts


def tune_vptree_alphas(
    method,
    store: DataStore,
    k: int = 10,
    desired_recall: float = 0.9,
    sample: int = 200,
    alpha_grid: list[float] | None = None,
    exp_grid: list[int] | None = None,
) -> dict:
    """Pick (alphaLeft/Right, expLeft/Right) maximizing pruning subject
    to recall >= desired_recall on sampled self-queries.

    Exp grid parity (searchoracle.cc:212 ``for ce = minExp..maxExp``
    runs the alpha optimization once per exponent and keeps the best
    improvement): for each exponent we walk alpha upward while recall
    holds, then keep the (exp, alpha) pair with the fewest distance
    computations among passing configs. The reference's defaults are
    minExp=maxExp=1 (searchoracle.h:50-51), so the default grid is the
    single exponent 1."""
    n = len(store)
    rng = np_rng(1234)
    q_pos = rng.choice(n, size=min(sample, n), replace=False)
    queries = _query_points(store, q_pos)

    gold = GoldStandard(method.space, store)
    ex_d, ex_ids = gold.compute_knn(queries, k)

    if alpha_grid is None:
        alpha_grid = [2.0**i for i in range(0, 16)]
    if exp_grid is None:
        exp_grid = [1]

    best = None
    old = (method.alpha_left, method.alpha_right, method.exp_left,
           method.exp_right, method.max_leaves)
    try:
        for e in exp_grid:
            method.exp_left = method.exp_right = float(e)
            found = None
            for a in alpha_grid:
                method.alpha_left = a
                method.alpha_right = a
                method.dist_comps = 0
                ad, aids = method.knn(queries, k)
                m = per_query_metrics(ex_d, ex_ids, ad, aids, check_invariant=False)
                rec = float(np.mean(m["recall"]))
                if rec >= desired_recall:
                    found = {
                        "alphaLeft": a,
                        "alphaRight": a,
                        "expLeft": float(e),
                        "expRight": float(e),
                        "recall": rec,
                        "dist_comps": method.dist_comps,
                    }
                else:
                    break
            if found is not None and (
                best is None or found["dist_comps"] < best["dist_comps"]
            ):
                best = found
    finally:
        (method.alpha_left, method.alpha_right, method.exp_left,
         method.exp_right, method.max_leaves) = old
    if best is None:
        # nothing met the target even at alpha=1 on some exponent: fall
        # back to the exact setting (reference reports best-effort too)
        best = {"alphaLeft": 1.0, "alphaRight": 1.0, "expLeft": 1.0,
                "expRight": 1.0, "recall": 1.0, "dist_comps": None}
    log("INFO", f"tune_vptree_alphas -> {best}")
    return best


def tune_hnsw_ef(
    method,
    store: DataStore,
    k: int = 10,
    desired_recall: float = 0.95,
    sample: int = 200,
    ef_max: int = 4096,
) -> dict:
    """Smallest efSearch reaching ``desired_recall`` on sampled
    self-queries (recall vs the exact gold standard), i.e. the highest-QPS
    operating point at the target quality.

    Framework extension: the reference's auto-tuner (tune.h
    GetOptimalAlphas) only covers the VP-tree pruner; HNSW users must
    hand-sweep efSearch. Same shape as the reference tuner: geometric
    ramp to bracket the target, then bisection. The method's efSearch is
    restored afterward; callers apply the returned value via
    set_query_time_params(Params(efSearch=...)).
    """
    n = len(store)
    rng = np_rng(1234)
    q_pos = rng.choice(n, size=min(sample, n), replace=False)
    queries = _query_points(store, q_pos)

    gold = GoldStandard(method.space, store)
    ex_d, ex_ids = gold.compute_knn(queries, k)

    def recall_at(ef: int) -> float:
        method.ef_search = max(int(ef), k)
        ad, aids = method.knn(queries, k)
        m = per_query_metrics(ex_d, ex_ids, ad, aids, check_invariant=False)
        return float(np.mean(m["recall"]))

    old_ef = method.ef_search
    tried: dict[int, float] = {}
    try:
        # geometric ramp to bracket the target
        lo, ef = None, max(k, 8)
        while ef <= ef_max:
            rec = tried[ef] = recall_at(ef)
            if rec >= desired_recall:
                break
            lo, ef = ef, ef * 2
        else:
            best_ef = max(tried, key=lambda e: (tried[e], -e))
            log(
                "WARNING",
                f"tune_hnsw_ef: recall {tried[best_ef]:.3f} < target "
                f"{desired_recall} even at efSearch={best_ef} (ef_max={ef_max})",
            )
            return {"efSearch": best_ef, "recall": tried[best_ef], "met": False}
        hi = ef
        # bisect (lo fails or is None, hi passes)
        while lo is not None and hi - lo > max(1, lo // 16):
            mid = (lo + hi) // 2
            rec = tried[mid] = recall_at(mid)
            if rec >= desired_recall:
                hi = mid
            else:
                lo = mid
        best = {"efSearch": hi, "recall": tried[hi], "met": True}
    finally:
        method.ef_search = old_ef
    log("INFO", f"tune_hnsw_ef -> {best}")
    return best
