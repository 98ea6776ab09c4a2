"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a JSON file of its own (``configs/<config>.json``,
``traffic/<traffic>.json``), and the cell's limits for ``correct`` are
``limits/<workload>.json``.  A configuration's ``kind`` names its runner,
``runners/<kind>.py``, and every metric is read by ``metrics/<name>.py``.
A later cell, mix, metric or runner is a new file and a new entry: no
file here changes.  ``root`` is the checkout (the directory that holds
``BENCHMARK.json``); ``bench_dir`` the directory these files lie in.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]   # the metrics this cell reports with --trace 0
    per_layer: List[Dict[str, Any]]    # ... and with --trace 1


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, prefix: str) -> ModuleType:
    """A module loaded from ``path`` under a name of its own (metric and
    runner names may hold ``-`` and ``.``)."""
    name = f"{prefix}{path.stem}".replace("-", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
    )


def runner(kind: str, bench_dir: Path = HERE) -> ModuleType:
    """``runners/<kind>.py``: ``run(cell, seed, seconds, trace, t_start)``."""
    return _load_module(bench_dir / "runners" / f"{kind}.py", "portbench_runner_")


def metric_reader(name: str, bench_dir: Path = HERE) -> ModuleType:
    """``metrics/<name>.py``: ``read(record) -> float or None``."""
    return _load_module(bench_dir / "metrics" / f"{name}.py", "portbench_metric_")


def read_metrics(metrics: List[Dict[str, Any]], record: Any,
                 bench_dir: Path = HERE) -> Dict[str, Dict[str, Any]]:
    """Each metric's reader on ``record``; a reader that finds nothing to
    read returns None, and the metric is left out."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], bench_dir).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
