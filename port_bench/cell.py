"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them:

* the configuration: ``port_bench/configs/<config>.json`` (its file), whose
  ``"driver"`` names the module that runs it, ``port_bench/<driver>.py``
  (``Run``, ``check``, ``passes``, ``control``);
* the traffic: ``port_bench/traffic/<traffic>.json``, whose
  ``"generator"`` names the module of its kind,
  ``port_bench/traffic/<generator>.py``;
* the limits of the comparison that decides ``correct``:
  ``port_bench/checks/<cell>.json``;
* each metric, end-to-end or per-layer: ``port_bench/metrics/<metric>.py``,
  whose ``read(ctx)`` returns the value, or None where the run has nothing
  to read.

A cell reports every end-to-end metric whose ``workloads`` name it (or
that has no ``workloads``), and every per-layer metric that names it, or
that has no ``workloads`` and moves an end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load(workload: str, bench_path: Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files read."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=workload, chips=int(w["chips"]), cfg=_json(ROOT / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                check=_json(HERE / "checks" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer)


def driver(cell: Cell):
    """The module ``port_bench/<driver>.py`` that runs ``cell``."""
    return importlib.import_module(f"port_bench.{cell.cfg['driver']}")


def reader(metric: str):
    """``port_bench/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
