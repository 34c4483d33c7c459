"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root pairs a configuration with a
traffic mix in each ``workloads`` entry.  Everything else is a file found by
a name, so that a later change adds a cell or a metric by adding files:

- ``configs[].file``: the configuration (model sizes as published, dtype);
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names ``portbench/drivers/<driver>.py``;
- ``portbench/limits/<workload>.json``: the limits of the correctness check;
- ``portbench/end_to_end/<metric>.py`` and ``portbench/metrics/<metric>.py``:
  one reader per metric, ``read(...) -> float or None``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{label}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read from
    under ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, chips=w["chips"], config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def driver(cell: Cell, root: Path = ROOT) -> ModuleType:
    return _load_module(root / "portbench" / "drivers" / f"{cell.traffic['driver']}.py",
                        "driver")


def reader(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric ``name``: ``kind`` is "end_to_end" or "metrics"."""
    return _load_module(root / "portbench" / kind / f"{name}.py", kind)


def read_metrics(entries: List[dict], kind: str, source, root: Path = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` of every entry whose reader finds a
    number in ``source``; the others are left out."""
    out = {}
    for m in entries:
        value = reader(kind, m["name"], root).read(source)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
