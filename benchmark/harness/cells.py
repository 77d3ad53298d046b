"""Cells, configurations, traffic mixes, limits and metric readers, found
by the names in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py`` under the benchmark's folder. A later cell, configuration or metric is a new file
here, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # the metrics of a --trace 0 run
    per_layer: List[Dict[str, Any]]  # the metrics of a --trace 1 run
    run_seconds: int
    limits: Dict[str, float]  # of the numbers compared (limits/<cell>.json)


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_cell(name: str, bench_json: str = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)
    with its configuration and traffic files and the metrics it reports."""
    bench = _load_json(bench_json or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = bench["end_to_end"]
    layer = bench["per_layer"]
    cfg = config(w["config"])
    cfg["name"] = w["config"]
    mix = traffic(w["traffic"])
    mix["name"] = w["traffic"]
    limits = _load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    return Cell(name, int(w["chips"]), cfg, mix, e2e, layer,
                int(bench["run_seconds"]), limits["limits"])


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: a module whose ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name: str) -> ModuleType:
    """``families/<name>.py``: how a configuration of that model family is
    built as the program and as the reference, and how one is compared."""
    return importlib.import_module(f"families.{name}")
