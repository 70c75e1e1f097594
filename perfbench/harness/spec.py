"""What one cell is, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic mix; each lives in a file
of its own under ``perfbench/`` (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``), and each
per-layer metric in ``metrics/<metric>.py``. Adding a cell, a configuration,
a traffic mix or a metric adds files and entries; no code changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    spec = _json(bench_path)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _json(ROOT / cfg_entry["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def reader(metric_name: str):
    """The ``read(summary)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
