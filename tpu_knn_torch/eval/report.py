"""Reporting (counterpart of tpu_knn/eval/report.py; reference:
include/report.h result tables, include/report_intr_dim.h intrinsic
dimensionality).

Intrinsic dimensionality follows Chavez et al. 2001 ("Searching in metric
spaces"): IntrDim = mean^2 / (2 var) over sampled pairwise distances
(report_intr_dim.h:30-68). The reference's loop over random pairs becomes
one distance block of sampled rows on the space's device."""

from __future__ import annotations

import numpy as np

from ..core.dataset import DataStore
from ..utils.logging import log
from ..utils.rng import np_rng
from .experiments import _query_points, _subset_store


def compute_intrinsic_dimensionality(space, store: DataStore, sample_qty: int = 10000, seed: int = 0) -> dict:
    """Returns {intrinsic_dim, dist_mean, dist_sigma, sample_qty}."""
    n = len(store)
    if n < 2:
        return {"intrinsic_dim": 0.0, "dist_mean": 0.0, "dist_sigma": 0.0, "sample_qty": 0}
    rng = np_rng(seed)
    # q rows x c rows with q*c ~ sample_qty, scored as one block
    qn = max(1, int(np.sqrt(sample_qty)))
    cn = max(1, sample_qty // qn)
    r1 = rng.integers(0, n, size=min(qn, n))
    r2 = rng.integers(0, n, size=min(cn, n))
    qenc = space.encode_queries(_query_points(store, r1))
    data = space.encode_dataset(_subset_store(store, r2))
    d = space.block(qenc, space.slice_data(data, 0, data.ids.shape[0])).cpu().numpy()
    d = d[:, : len(r2)].reshape(-1)
    # the NaN check comes BEFORE the finite filter, which would drop the
    # very values this FATAL of the reference exists to catch
    # (report_intr_dim.h); +inf padding terms are legitimate and dropped
    if np.isnan(d).any():
        raise RuntimeError("!!! Bug: a distance returned NAN!")
    d = d[np.isfinite(d)]
    mean = float(np.mean(d))
    var = float(np.var(d))
    return {
        "intrinsic_dim": mean * mean / (2 * var) if var > 0 else float("inf"),
        "dist_mean": mean,
        "dist_sigma": float(np.sqrt(var)),
        "sample_qty": int(d.size),
    }


def report_intrinsic_dimensionality(report_name: str, space, store: DataStore, sample_qty: int = 10000) -> dict:
    r = compute_intrinsic_dimensionality(space, store, sample_qty)
    log("INFO", f"### {report_name}")
    log("INFO", f"### intrinsic dim: {r['intrinsic_dim']}")
    log("INFO", f"### distance mean: {r['dist_mean']}")
    log("INFO", f"### distance sigma: {r['dist_sigma']}")
    return r


def format_table(rows: list[dict], columns: list[str] | None = None) -> str:
    """Plain-text result table (report.h)."""
    if not rows:
        return "(no results)"
    if columns is None:
        columns = [k for k in rows[0] if k != "params"]
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in columns}
    head = "  ".join(c.ljust(widths[c]) for c in columns)
    sep = "  ".join("-" * widths[c] for c in columns)
    body = "\n".join("  ".join(_fmt(r.get(c)).ljust(widths[c]) for c in columns) for r in rows)
    return f"{head}\n{sep}\n{body}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)
