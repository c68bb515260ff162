"""BENCHMARK.json against the contract's shape, and the harness finding a
cell, a traffic mix and a metric that exist only as new files."""

import hashlib
import json
import re
import shutil
import time

import pytest

from knnbench import harness
from knnbench.registry import ROOT, find, load_cell, load_spec

from .conftest import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    spec = load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = load_cell(w["name"])
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert (ROOT / "knnbench" / "limits" / f"{w['name']}.json").is_file()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(find("metrics", m["name"]).read)
    for c in spec["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def _digests():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in [ROOT / "BENCHMARK.json", *sorted((ROOT / "knnbench").rglob("*"))] if p.is_file()
            and "__pycache__" not in p.parts}


RECALL_METRIC = """
import torch


def read(run):
    \"\"\"Share of the float64 scan's k nearest rows that the answers hold.\"\"\"
    ref, k, hit, total = run.reference, int(run.cell.traffic["k"]), 0, 0
    for b, outs in run.answers.items():
        s, e = run.inputs.batch_rows(b)
        best = torch.topk(ref.form.exact(s, e), k, dim=1, largest=False).indices
        for _, ids in outs:
            pos = ref._positions(ids)
            hit += int((pos[:, :, None] == best[:, None, :]).any(2).sum())
            total += best.numel()
    return hit / total if total else None
"""

RECALL_CHECK = """
from knnbench.registry import find


def numbers(run):
    return {"recall_shortfall": 1.0 - find("metrics", "recall_at_k", run.cell.root).read(run)}
"""


def test_new_cell_mix_metric_and_check_as_files_only(tmp_path):
    """A later change adds a configuration (with Index keyword arguments,
    query-time parameters and a check of its own), a traffic mix, a metric
    that reads the window's answers against the reference, and a cell, as new
    files and entries: the harness runs them with no file of its own edited."""
    before = _digests()
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "knnbench", root / "knnbench", ignore=shutil.ignore_patterns("__pycache__"))
    small = tiny_cell("sift128-l2-knn10-b2048").config
    config = dict(small, name="sift-128-euclidean-2shard", index_kwargs={"mesh": 2},
                  query_params={"dummyParam": 0}, check="recall")
    (root / "knnbench" / "configs" / "sift-128-euclidean-2shard.json").write_text(json.dumps(config))
    spec = load_spec()
    spec["configs"].append({"name": config["name"], "source": "https://github.com/erikbern/ann-benchmarks",
                            "file": "knnbench/configs/sift-128-euclidean-2shard.json", "reduced": [],
                            "why": "a configuration added as a file"})
    spec["workloads"].append({"name": "sift128-2shard-knn5-b16", "config": config["name"],
                              "traffic": "knn5-b16", "chips": 1, "why": "a cell added as files"})
    spec["per_layer"].append({"name": "recall_at_k", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "api", "moves": "qps",
                              "workloads": ["sift128-2shard-knn5-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "knnbench" / "traffic" / "knn5-b16.json").write_text(json.dumps(
        {"kind": "knn", "k": 5, "batch": 16, "pool_batches": 2, "in_flight": 2}))
    (root / "knnbench" / "metrics" / "recall_at_k.py").write_text(RECALL_METRIC)
    (root / "knnbench" / "checks" / "recall.py").write_text(RECALL_CHECK)
    (root / "knnbench" / "limits" / "sift128-2shard-knn5-b16.json").write_text('{"recall_shortfall": 0.05}')
    cell = load_cell("sift128-2shard-knn5-b16", root)
    assert cell.traffic["k"] == 5 and [m["name"] for m in cell.per_layer] == ["recall_at_k"]
    res, lines = harness.run_cell(cell, 4, 0.3, True, "cpu", time.perf_counter())
    assert res["correct"] and res["metrics"]["recall_at_k"]["value"] == 1.0, res
    assert res["checks"] == {"recall_shortfall": {"value": 0.0, "limit": 0.05}}
    assert _digests() == before


def test_range_rejects_in_flight():
    cell = tiny_cell("sift128-l2-range-b2048")
    cell.traffic["in_flight"] = 2
    with pytest.raises(ValueError, match="in_flight"):
        harness.run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter())


def test_unknown_workload():
    with pytest.raises(KeyError):
        load_cell("no-such-cell")
