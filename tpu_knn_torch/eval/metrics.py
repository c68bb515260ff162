"""Quality metrics (counterpart of tpu_knn/eval/metrics.py, pure numpy and
the same code; reference: include/eval_metrics.h, eval_results.h).

All metrics are computed per query from the exact (gold-standard) result
list and the approximate result list, then averaged by the caller:

  recall              |approx ∩ exact| / |exact|            (EvalRecall)
  recall@1            indicator that approx[0] is the exact nearest
  number_closer       # exact entries strictly closer than approx[0]
                      (EvalNumberCloser)
  precision_of_approx 1/K sum (k+1)/(pos_k+1)               (Zezula et al.)
  log_rel_pos_error   1/K sum log((pos_k+1)/(k+1))          (EvalLogRelPosError)
  class_accuracy      approx majority label == exact majority label

with pos_k = the position the k-th approximate answer would occupy in
the exact ordering (>= k by construction, mirroring the CHECK(p >= k)
alignment loop of eval_metrics.h:55-108).

The hard invariant of the reference (eval_metrics.h LIB_FATAL at :76) is
kept: an approximate result may never be closer than the exact one at
the same rank beyond floating-point tolerance — that is a bug in the
caller's index, not a quality deficit — and raises AssertionError.
"""

from __future__ import annotations

import numpy as np

#: tolerances mirroring ApproxEqual (utils.h) float comparison, widened
#: to cover the matmul-factored kernels' f32 noise: |q|^2+|x|^2-2qx can
#: miss true zero by ~1e-6, i.e. ~1.5e-3 after the sqrt.
_REL_TOL = 1e-3
_ABS_TOL = 5e-3


def _approx_le(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a <= b up to float tolerance."""
    return a <= b + _REL_TOL * np.maximum(np.abs(a), np.abs(b)) + _ABS_TOL


def check_no_better_than_exact(exact_d: np.ndarray, approx_d: np.ndarray) -> None:
    """The 'approx can't beat exact' invariant (eval_metrics.h:55-108)."""
    k = min(exact_d.shape[1], approx_d.shape[1])
    ex, ap = exact_d[:, :k], approx_d[:, :k]
    ok = _approx_le(ex, ap) | ~np.isfinite(ap)
    if not ok.all():
        q, r = np.argwhere(~ok)[0]
        raise AssertionError(
            "bug: the approximate query should not return objects that are "
            "closer to the query than objects returned by (exact) sequential "
            f"searching! query={q} rank={r} approx={ap[q, r]} exact={ex[q, r]}"
        )


def _positions(exact_d: np.ndarray, approx_d: np.ndarray) -> np.ndarray:
    """pos_k per approx entry: #exact entries strictly closer (with
    tolerance), clipped to >= k (the p >= k loop invariant)."""
    q, ka = approx_d.shape
    # strictly-closer counts via broadcasted compare (K_exact is small);
    # padded inf entries get an inf threshold directly (inf - inf = nan)
    ap = approx_d[:, :, None]
    with np.errstate(invalid="ignore"):
        thr = np.where(np.isfinite(ap), ap - _REL_TOL * np.abs(ap) - _ABS_TOL, ap)
    closer = exact_d[:, None, :] < thr
    pos = closer.sum(axis=2)
    pos = np.maximum(pos, np.arange(ka)[None, :])
    return pos


def per_query_metrics(
    exact_d: np.ndarray,
    exact_ids: np.ndarray,
    approx_d: np.ndarray,
    approx_ids: np.ndarray,
    check_invariant: bool = True,
) -> dict[str, np.ndarray]:
    """All metrics, each as a [Q] vector. Missing results (-1 ids / inf
    dists) are handled like the reference's empty-result branches."""
    if check_invariant:
        check_no_better_than_exact(exact_d, approx_d)
    q = exact_d.shape[0]
    ex_valid = exact_ids >= 0
    ap_valid = approx_ids >= 0
    ex_size = np.maximum(ex_valid.sum(1), 1)

    inter = np.zeros(q)
    for i in range(q):
        inter[i] = np.intersect1d(
            approx_ids[i][ap_valid[i]], exact_ids[i][ex_valid[i]]
        ).size
    recall = np.where(ex_valid.any(1), inter / ex_size, 1.0)

    recall_at1 = np.where(
        ex_valid[:, 0],
        (approx_ids[:, 0] == exact_ids[:, 0])
        | _approx_le(approx_d[:, 0], exact_d[:, 0]),
        1.0,
    ).astype(float)

    # number closer: exact entries strictly closer than the best approx
    first_ap = np.where(ap_valid[:, 0], approx_d[:, 0], np.inf)[:, None]
    with np.errstate(invalid="ignore"):
        fthr = np.where(
            np.isfinite(first_ap),
            first_ap - _REL_TOL * np.abs(first_ap) - _ABS_TOL,
            first_ap,
        )
    closer = (exact_d < fthr) & ex_valid
    number_closer = closer.sum(1).astype(float)

    pos = _positions(exact_d, approx_d)
    kk = np.arange(approx_d.shape[1])[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        pa_terms = np.where(ap_valid, (kk + 1) / (pos + 1), 0.0)
        le_terms = np.where(ap_valid, np.log((pos + 1) / (kk + 1)), 0.0)
    n_ap = np.maximum(ap_valid.sum(1), 1)
    # empty-vs-empty is a perfect answer (range queries routinely have
    # empty gold sets); only an empty approx against non-empty gold is
    # a quality-0 result
    empty_fill = np.where(ex_valid.any(1), 0.0, 1.0)
    precision_of_approx = np.where(ap_valid.any(1), pa_terms.sum(1) / n_ap, empty_fill)
    log_rel_pos_error = np.where(
        ap_valid.any(1), le_terms.sum(1) / n_ap, np.log(ex_size)
    )

    return {
        "recall": recall,
        "recall@1": recall_at1,
        "number_closer": number_closer,
        "precision_of_approx": precision_of_approx,
        "log_rel_pos_error": log_rel_pos_error,
    }


def class_accuracy(
    exact_labels: np.ndarray, approx_labels: np.ndarray
) -> np.ndarray:
    """Majority-vote label agreement (EvalClassAccuracy analog)."""

    def majority(row):
        row = row[row >= 0]
        if row.size == 0:
            return -1
        vals, counts = np.unique(row, return_counts=True)
        return vals[np.argmax(counts)]

    ex = np.apply_along_axis(majority, 1, exact_labels)
    ap = np.apply_along_axis(majority, 1, approx_labels)
    return (ex == ap).astype(float)


def summarize(per_query: dict[str, np.ndarray]) -> dict[str, float]:
    return {k: float(np.mean(v)) for k, v in per_query.items()}
