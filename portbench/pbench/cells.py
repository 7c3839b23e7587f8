"""Cells found by name: a ``BENCHMARK.json`` workload names a
configuration (``configs/<config>.json``), a traffic mix
(``traffic/<mix>.json``, whose ``driver`` names the general driver that
reads it, ``pbench/<driver>.py``) and, through the per-layer metrics that
list it, the readers (``metrics/<metric>.py``).  Adding a cell, a mix, a
kind of driver or a metric adds files and entries; no file of the harness
changes."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    driver: type = None
    readers: Dict[str, object] = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{metric}.py"


def driver_path(driver: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "pbench" / f"{driver}.py"


def _applies(metric: dict, cell: str, e2e: Dict[str, dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = e2e.get(metric["moves"], {})
    return "workloads" not in moved or cell in moved["workloads"]


def load(bench: dict, root: Path, name: str,
         bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json's content): its
    configuration file from the checkout at ``root``, its mix, the mix's
    driver (the module's ``Run``) and the readers by name from
    ``bench_dir``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / confs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, by_name)]
    cell = Cell(name, w["chips"], config, traffic, e2e, per_layer)
    cell.driver = load_module(driver_path(traffic["driver"], bench_dir),
                              "pbench." + traffic["driver"]).Run
    for m in per_layer:
        mod_name = "metric_" + m["name"].replace(".", "_")
        cell.readers[m["name"]] = load_module(
            reader_path(m["name"], bench_dir), mod_name)
    return cell
