"""Finds what a cell is made of, by the names in ``BENCHMARK.json``: the
configuration's file, the traffic mix's file (``traffic/<name>.json``),
the cell's correctness limits (``limits/<workload>.json``), the reference
family that the configuration names (``reference/<family>.py``) and one
reader per metric (``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    workload: Dict
    config: Dict            # the configuration file's contents
    traffic: Dict           # the traffic file's contents
    limits: Dict            # {number: limit} that decide ``correct``
    end_to_end: List[Dict]
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reported(metric: Dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "cleave_bench" / "traffic"
                        / f"{w['traffic']}.json")
    limits = load_json(root / "cleave_bench" / "limits" / f"{workload}.json")
    return Cell(workload=w, config=config, traffic=traffic,
                limits=limits["limits"],
                end_to_end=[m for m in bench["end_to_end"]
                            if reported(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if reported(m, workload)])


def family(config: Dict) -> ModuleType:
    """The plain reference module of the configuration's family."""
    return importlib.import_module(f"reference.{config['reference']}")


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``, loaded by its path."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cleave_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
