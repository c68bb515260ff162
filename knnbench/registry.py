"""Where the harness finds each piece, by name.

* ``BENCHMARK.json`` at the root: the cells (``workloads``), the
  configurations and the metrics;
* a configuration: the JSON file its ``configs`` entry names;
* a traffic mix: ``knnbench/traffic/<traffic>.json``;
* a metric (end-to-end or per-layer): ``knnbench/metrics/<name>.py``, a
  module with ``read(run)`` that returns the metric's value or None when
  the run has nothing for it to read (``harness.Run`` holds the window's
  timings, its trace, its answers and the reference);
* a traffic kind (the entry a mix drives): ``knnbench/kinds/<kind>.py``;
* a comparison that decides ``correct`` (a configuration's ``check``):
  ``knnbench/checks/<check>.py``, with limits in ``knnbench/limits/<cell>.json``;
* a data recipe or distance form that ``data.py`` or ``reference.py`` lacks:
  ``knnbench/recipes/<name>.py`` or ``knnbench/forms/<name>.py``.

A later cell, mix or metric is added as files and entries; no file here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

#: the checkout: the directory that holds BENCHMARK.json and this package
ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; known: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "knnbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        root=root,
    )


def load_module(path: Path):
    """Import a file of the benchmark as a module of its own."""
    mod_name = "knnbench._loaded." + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str, root: Path = ROOT):
    """``knnbench/<kind>/<name>.py`` as a module: a metric's reader, or the
    module whose ``make`` a recipe or form names."""
    path = Path(root) / "knnbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return load_module(path)
