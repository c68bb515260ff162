"""Experiment CLI (counterpart of tpu_knn/cli.py): the flag surface of the
reference's ``experiment`` binary (include/params_def.h flag names,
include/cmd_options.h, src/params_cmdline.cc).

Usage:
    python -m tpu_knn_torch --spaceType l2 --spaceParams dim=128 \
        --dataFile vectors.fvecs --method hnsw \
        --createIndex M=16,efConstruction=200 \
        --queryTimeParams efSearch=50 --queryTimeParams efSearch=200 \
        --knn 10 --testSetQty 2 --maxNumQuery 200 --device cuda

``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions)
places every tensor; with ``cuda`` and no card the run fails, there is no
fallback. ``--platform`` is kept as a synonym: ``cpu`` is the CPU,
``gpu``/``cuda`` the card. Dense data files are whitespace-separated
vectors, one per line, or fvecs/bvecs/ivecs by extension; sparse files
are "id:val" pairs per line (1-based ascending ids); string spaces read
raw lines. Results print as a table per k and per radius (report.h).
An index saved with ``--saveIndex`` is format v3 and loads in tpu_knn's
CLI too, and the other way round.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .core.dataset import DataKind, DataStore, DistKind
from .core.errors import InvalidArgumentError
from .core.params import Params
from .core.registry import create_method, create_space
from .eval.experiments import ExperimentConfig, Experiments, MetaAnalysis, _query_points, _subset_store
from .eval.report import format_table
from .utils.logging import LOGGER, log

#: --platform values and the device each names
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _parse_kv(s: str) -> Params:
    return Params([kv.strip() for kv in s.split(",") if kv.strip()])


def _read_dense(path: str) -> np.ndarray:
    """Dense matrix from whitespace text or fvecs/bvecs/ivecs (by extension)."""
    from .io.native import read_dense_text, read_vecs

    if path.rsplit(".", 1)[-1].lower() in ("fvecs", "bvecs", "ivecs"):
        return read_vecs(path)
    return read_dense_text(path)


def _load_store(space, path: str, max_num: int) -> DataStore:
    kind = space.data_kind
    store = DataStore(kind)
    if kind is DataKind.DENSE:
        mat = _read_dense(path).astype(np.float32, copy=False)
        store.add_dense_batch(mat[:max_num] if max_num else mat)
    elif kind is DataKind.UINT8:
        mat = _read_dense(path).astype(np.uint8)
        store.add_uint8_batch(mat[:max_num] if max_num else mat)
    elif kind is DataKind.SPARSE:
        from .io.native import read_sparse_text

        row_len, ids, vals = read_sparse_text(path)
        pts, off = [], 0
        for n in row_len[: max_num or None]:
            pts.append((ids[off: off + n], vals[off: off + n]))
            off += int(n)
        store.add_sparse_batch(pts)
    else:
        with open(path, "rb") as f:
            lines = [ln.rstrip(b"\n") for ln in f if ln.strip()]
        store.add_string_batch(lines[:max_num] if max_num else lines)
    return store


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_knn_torch", description="similarity-search experiment harness")
    a = p.add_argument
    a("--spaceType", "-s", required=True, help="space type, e.g., l1, l2, lp")
    a("--spaceParams", default="", help="space parameters key=value[,key=value]")
    a("--distType", default="float", choices=["int", "float"], help="distance value type")
    a("--dataFile", "-i", required=True, help="input data file")
    a("--maxNumData", "-D", type=int, default=0, help="use only the first maxNumData elements")
    a("--queryFile", "-q", default="", help="query file")
    a("--maxNumQuery", "-Q", type=int, default=0, help="number of queries (bootstrapping)")
    a("--testSetQty", "-b", type=int, default=1, help="# of bootstrap test sets (ignored if queryFile)")
    a("--method", "-m", default="hnsw", help="index method")
    a("--createIndex", "-c", default="", help="index-time parameters")
    a("--queryTimeParams", "-t", action="append", default=[], help="query-time parameter set (repeatable)")
    a("--knn", "-k", default="", help="comma-separated K values for k-NN search")
    a("--range", "-r", dest="range_", default="", help="comma-separated radii for range searches")
    a("--saveIndex", "-S", default="", help="location to save the index to")
    a("--loadIndex", "-L", default="", help="location to load the index from")
    a("--cachePrefixGS", "-g", default="", help="gold-standard cache file prefix")
    a("--recallOnly", action="store_true", help="compute only recall")
    a("--logFile", "-l", default="", help="log file")
    a("--outFile", "-o", default="", help="result output file (default stdout)")
    a("--device", default="cuda", help="torch device of the index: cuda (default) or cpu")
    a("--platform", default="", help="synonym of --device: cpu, or gpu/cuda")
    return p


def _device(args):
    """The run's device: --platform when given, else --device; a CUDA
    device without a card raises (api._resolve_device)."""
    from .api import _resolve_device

    dev = args.device
    if args.platform:
        if args.platform not in _PLATFORMS:
            raise InvalidArgumentError(
                f"--platform {args.platform!r} has no device here: use cpu, or gpu/cuda for the card"
            )
        dev = _PLATFORMS[args.platform]
    return _resolve_device(dev)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _device(args)
    if args.logFile:
        LOGGER.set_file(args.logFile)
    out = open(args.outFile, "w") if args.outFile else sys.stdout

    space = create_space(args.spaceType, _parse_kv(args.spaceParams), device=dev)
    if DistKind(args.distType) is not space.dist_kind:
        raise InvalidArgumentError(
            f"--distType {args.distType} does not match space "
            f"{args.spaceType!r} ({space.dist_kind.value} distances)"
        )
    if (args.saveIndex or args.loadIndex) and not args.queryFile:
        raise InvalidArgumentError(
            "--saveIndex/--loadIndex require --queryFile: bootstrap test "
            "splits build a different index per split"
        )
    loaded_method = None
    if args.loadIndex:
        from .api import Index

        lidx = Index.load(args.loadIndex, device=dev)
        store = lidx.store
        space = lidx.space
        loaded_method = lidx.method
        log("INFO", f"loaded index from {args.loadIndex} ({len(store)} points)")
    else:
        store = _load_store(space, args.dataFile, args.maxNumData)
        log("INFO", f"loaded {len(store)} data points from {args.dataFile}")
    qparams = [_parse_kv(q) if q else None for q in (args.queryTimeParams or [None])]
    ks = [int(v) for v in args.knn.split(",") if v.strip()]
    radii = [float(v) for v in args.range_.split(",") if v.strip()]

    def method_factory(sp):
        return create_method(args.method, sp, _parse_kv(args.createIndex))

    def _save_built(method, sub) -> None:
        """Persist through the two-artifact format Index.load reads."""
        from .api import Index

        sidx = Index(args.spaceType, _parse_kv(args.spaceParams), args.method, store.kind, args.distType,
                     device=dev)
        sidx.space = space  # the instance the method was built with
        sidx.store = sub
        sidx.method = method
        sidx._index_params = _parse_kv(args.createIndex)
        sidx.built = True
        sidx.save(args.saveIndex)
        log("INFO", f"saved index to {args.saveIndex}")

    if args.queryFile:
        splits = [(None, _load_store(space, args.queryFile, args.maxNumQuery))]
    else:
        cfg = ExperimentConfig(test_set_qty=max(args.testSetQty, 1), query_qty=args.maxNumQuery or 100)
        splits = list(cfg.split(len(store)))

    def split_data(split):
        if args.queryFile:
            return store, _query_points(split[1], np.arange(len(split[1])))
        return _subset_store(store, split[0]), _query_points(store, split[1])

    def built_method(sub, save: bool):
        if loaded_method is not None:
            return loaded_method  # already built on the full store
        method = method_factory(space)
        method.create_index(sub)
        if save:
            _save_built(method, sub)
        return method

    for k in ks:
        metas: dict[int, MetaAnalysis] = {}
        for split in splits:
            sub, queries = split_data(split)
            method = built_method(sub, bool(args.saveIndex))
            ex = Experiments(space, sub, queries, k)
            for i, row in enumerate(ex.run(method, qparams)):
                metas.setdefault(i, MetaAnalysis()).add(row)
            if args.cachePrefixGS:
                # after run(): the kNN gold standard is computed by it
                ex.gold.save_cache(f"{args.cachePrefixGS}.k{k}")
        cols = ["recall"] if args.recallOnly else [
            "recall", "recall@1", "number_closer", "log_rel_pos_error", "precision_of_approx", "qps",
            "improv_dist_comp",
        ]
        _print_table(out, f"kNN k={k}", args, qparams, sorted(metas.items()), cols)

    # range sweeps: one index per split, every radius against it (the
    # index does not depend on the radius)
    rmetas: dict[tuple[float, int], MetaAnalysis] = {}
    if radii:
        for split in splits:
            sub, queries = split_data(split)
            # the kNN loop saved one already, if it ran
            method = built_method(sub, bool(args.saveIndex) and not ks)
            ex = Experiments(space, sub, queries)
            for r in radii:
                for i, row in enumerate(ex.run_range(method, r, qparams)):
                    rmetas.setdefault((r, i), MetaAnalysis()).add(row)
    cols = ["recall"] if args.recallOnly else [
        "recall", "number_closer", "log_rel_pos_error", "precision_of_approx", "qps", "improv_dist_comp",
        "mean_result_size",
    ]
    for r in radii:
        items = [(i, m) for (rr, i), m in sorted(rmetas.items()) if rr == r]
        _print_table(out, f"range r={r}", args, qparams, items, cols)

    if args.outFile:
        out.close()
    return 0


def _print_table(out, title: str, args, qparams, items, cols) -> None:
    """One result table: a row per query-time parameter set, the mean over
    splits of each column."""
    rows = []
    for i, m in items:
        agg = m.aggregate()
        row = {"params": str(qparams[i].as_dict() if qparams[i] else {})}
        for c in cols:
            if c in agg:
                row[c] = agg[c]["mean"]
        rows.append(row)
    print(f"\n=== {title} (method={args.method}, space={args.spaceType}) ===", file=out)
    print(format_table(rows, ["params"] + [c for c in rows[0] if c != "params"]), file=out)


if __name__ == "__main__":
    raise SystemExit(main())
