"""Experiment runner and cross-split aggregation (counterpart of
tpu_knn/eval/experiments.py; reference: include/experiments.h
Experiments::RunAll/Execute, include/experimentconf.h ExperimentConfig,
include/meta_analysis.h MetaAnalysis, include/report.h).

``ExperimentConfig`` does the reference's bootstrap splitting
(experimentconf.h:40-150): ``test_set_qty`` random splits, each holding
out ``query_qty`` points as queries. ``Experiments.run`` sweeps query-time
parameter sets, timing batched kNN and collecting the eval metrics plus
the reference's efficiency numbers (QPS, improvement in distance
computations over the sequential scan). ``MetaAnalysis`` aggregates the
per-split rows into mean, std and a 95% confidence half-width.

Timing is ``time.perf_counter`` around the method call. The port's
methods return host numpy arrays, so the call has already waited for the
device when the clock stops: the time includes the device sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.dataset import DataKind, DataStore
from ..core.params import Params
from ..utils.rng import np_rng
from .gold_standard import GoldStandard
from .metrics import class_accuracy, per_query_metrics, summarize


@dataclass
class ExperimentConfig:
    """Bootstrap splitting of one dataset into index data + query sets."""

    test_set_qty: int = 1
    query_qty: int = 100
    seed: int = 0

    def split(self, n: int):
        """Yields (index_positions, query_positions) per test set."""
        rng = np_rng(self.seed)
        for _ in range(self.test_set_qty):
            perm = rng.permutation(n)
            q = min(self.query_qty, max(n - 1, 1))
            yield np.sort(perm[q:]), np.sort(perm[:q])


def _subset_store(store: DataStore, positions: np.ndarray) -> DataStore:
    """The points at ``positions`` with their ids (labels are not carried,
    as in tpu_knn)."""
    sub = DataStore(store.kind)
    ids = [store.ids[p] for p in positions]
    pts = [store.get_point(int(p)) for p in positions]
    if store.kind is DataKind.DENSE:
        sub.add_dense_batch(np.stack(pts), ids)
    elif store.kind is DataKind.UINT8:
        sub.add_uint8_batch(np.stack(pts), ids)
    elif store.kind is DataKind.SPARSE:
        sub.add_sparse_batch(pts, ids)
    else:
        sub.add_string_batch(pts, ids)
    return sub


def _query_points(store: DataStore, positions: np.ndarray):
    """The points at ``positions`` as a query batch (a matrix for dense
    kinds, a list otherwise)."""
    pts = [store.get_point(int(p)) for p in positions]
    if store.kind in (DataKind.DENSE, DataKind.UINT8):
        return np.stack(pts)
    return pts


class Experiments:
    """Parameter-sweep runner over one (index data, queries) pair."""

    def __init__(self, space, index_store: DataStore, queries, k: int = 10):
        self.space = space
        self.store = index_store
        self.queries = queries
        self.k = k
        self.gold = GoldStandard(space, index_store)
        # the kNN gold is computed on the first run() (a range-only
        # experiment does not pay for a kNN scan), the range gold per
        # radius on the first run_range(radius)
        self.exact_d: np.ndarray | None = None
        self.exact_ids: np.ndarray | None = None
        self._range_gold: dict[float, tuple[np.ndarray, np.ndarray]] = {}
        self.n = len(index_store)
        self._labels = index_store.label_of_id() if any(l != -1 for l in index_store.labels) else None

    def run(self, method, query_param_sets: list[Params | dict | None], warmup: bool = True):
        """Returns one result row (dict) per query-time parameter set."""
        if self.exact_d is None:
            self.exact_d, self.exact_ids = self.gold.compute_knn(self.queries, self.k)
        rows = []
        nq = self.exact_d.shape[0]
        for qp in query_param_sets:
            method.set_query_time_params(Params.of(qp) if qp is not None else None)
            if warmup:
                method.knn(self.queries, self.k)  # build caches outside the timing
            dc0 = getattr(method, "dist_comps", 0)
            t0 = time.perf_counter()
            ad, aids = method.knn(self.queries, self.k)
            dt = max(time.perf_counter() - t0, 1e-9)
            dc = getattr(method, "dist_comps", 0) - dc0
            row = summarize(per_query_metrics(self.exact_d, self.exact_ids, ad, aids))
            if self._labels is not None:
                lab = np.vectorize(lambda i: self._labels.get(int(i), -1))
                row["class_accuracy"] = float(np.mean(class_accuracy(lab(self.exact_ids), lab(aids))))
            row["qps"] = nq / dt
            row["query_time_ms"] = dt * 1e3 / nq
            # improvement in distance computations over the sequential scan
            # (query.h:33, experiments.h:136-140)
            row["improv_dist_comp"] = (nq * self.n) / max(dc, 1) if dc else float("inf")
            row["dist_comps"] = int(dc)
            row["params"] = Params.of(qp).as_dict() if qp is not None else {}
            rows.append(row)
        return rows

    def run_range(self, method, radius: float, query_param_sets: list[Params | dict | None], warmup: bool = True):
        """Range-query sweep: one result row per parameter set, with the kNN
        quality metrics against the exact range gold standard (the
        reference runs both sweeps through EvalResults,
        experiments.h:58-319)."""
        radius = float(radius)
        if radius not in self._range_gold:
            self._range_gold[radius] = _pad_result_lists(self.gold.compute_range(self.queries, radius))
        gd, gids = self._range_gold[radius]
        rows = []
        nq = gd.shape[0]
        for qp in query_param_sets:
            method.set_query_time_params(Params.of(qp) if qp is not None else None)
            if warmup:
                method.range(self.queries, radius)
            dc0 = getattr(method, "dist_comps", 0)
            t0 = time.perf_counter()
            res = method.range(self.queries, radius)
            dt = max(time.perf_counter() - t0, 1e-9)
            dc = getattr(method, "dist_comps", 0) - dc0
            ad, aids = _pad_result_lists(res)
            # one width for both, so per_query_metrics sees rectangles.
            # check_invariant=False: "approx cannot beat exact" is a kNN
            # invariant; a range list may hold a boundary point the gold
            # scan's comparison left out, a finite distance against a gold
            # inf pad at the same rank
            w = max(gd.shape[1], ad.shape[1])
            m = per_query_metrics(
                _pad_to(gd, w, np.inf), _pad_to(gids, w, -1),
                _pad_to(ad, w, np.inf), _pad_to(aids, w, -1),
                check_invariant=False,
            )
            row = summarize(m)
            row["qps"] = nq / dt
            row["query_time_ms"] = dt * 1e3 / nq
            row["improv_dist_comp"] = (nq * self.n) / max(dc, 1) if dc else float("inf")
            row["dist_comps"] = int(dc)
            row["mean_result_size"] = float(np.mean([len(ids) for ids, _ in res]))
            row["radius"] = radius
            row["params"] = Params.of(qp).as_dict() if qp is not None else {}
            rows.append(row)
        return rows


def _pad_result_lists(results) -> tuple[np.ndarray, np.ndarray]:
    """[(ids, dists)] per query -> rectangular (dists, ids), each row sorted
    by distance (stable) and padded with (+inf, -1)."""
    q = len(results)
    m = max([len(ids) for ids, _ in results] + [1])
    d = np.full((q, m), np.inf, np.float32)
    ids = np.full((q, m), -1, np.int64)
    for i, (rid, rd) in enumerate(results):
        rid, rd = np.asarray(rid), np.asarray(rd, np.float32)
        o = np.argsort(rd, kind="stable")
        ids[i, : o.size] = rid[o]
        d[i, : o.size] = rd[o]
    return d, ids


def _pad_to(a: np.ndarray, width: int, fill) -> np.ndarray:
    if a.shape[1] >= width:
        return a
    return np.concatenate([a, np.full((a.shape[0], width - a.shape[1]), fill, a.dtype)], axis=1)


@dataclass
class MetaAnalysis:
    """Aggregates result rows across test splits (meta_analysis.h)."""

    rows: list[dict] = field(default_factory=list)

    def add(self, row: dict) -> None:
        self.rows.append(row)

    def aggregate(self) -> dict:
        if not self.rows:
            return {}
        keys = [k for k, v in self.rows[0].items() if isinstance(v, (int, float))]
        out = {}
        for k in keys:
            vals = np.asarray([r[k] for r in self.rows], float)
            finite = vals[np.isfinite(vals)]
            mean = float(np.mean(finite)) if finite.size else float("inf")
            std = float(np.std(finite, ddof=1)) if finite.size > 1 else 0.0
            # normal-approximation 95% half-width, as meta_analysis.h reports
            out[k] = {"mean": mean, "std": std, "ci95": 1.96 * std / np.sqrt(max(len(finite), 1))}
        return out


def run_full_experiment(
    space,
    store: DataStore,
    method_factory,
    config: ExperimentConfig,
    query_param_sets,
    k: int = 10,
    range_radii: tuple[float, ...] = (),
):
    """RunAll: split -> build -> sweep -> aggregate. Returns the kNN
    aggregate rows; with ``range_radii``, ``(knn_aggs, {radius: aggs})``
    over the same splits and indexes (experiments.h:58-319)."""
    metas: dict[int, MetaAnalysis] = {}
    rmetas: dict[tuple[float, int], MetaAnalysis] = {}
    for idx_pos, q_pos in config.split(len(store)):
        sub = _subset_store(store, idx_pos)
        queries = _query_points(store, q_pos)
        method = method_factory(space)
        method.create_index(sub)
        ex = Experiments(space, sub, queries, k)
        for i, row in enumerate(ex.run(method, query_param_sets)):
            metas.setdefault(i, MetaAnalysis()).add(row)
        for r in range_radii:
            for i, row in enumerate(ex.run_range(method, r, query_param_sets)):
                rmetas.setdefault((float(r), i), MetaAnalysis()).add(row)
    knn_aggs = [m.aggregate() for _, m in sorted(metas.items())]
    if not range_radii:
        return knn_aggs
    range_aggs: dict[float, list[dict]] = {}
    for (r, _), m in sorted(rmetas.items()):
        range_aggs.setdefault(r, []).append(m.aggregate())
    return knn_aggs, range_aggs
