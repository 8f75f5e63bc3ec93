"""The harness: one cell of ``BENCHMARK.json`` per process.

Everything that belongs to one configuration, one traffic mix, one kind
of entry or one per-layer metric is a file of its own, found by name:

* a configuration: the ``file`` its entry in ``BENCHMARK.json`` names;
* a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` key names
  the kind of entry that runs it;
* a kind of entry: ``drivers/<driver>.py`` with ``run(run: Run) -> dict``
  (the outcome, see `finish`);
* a per-layer metric: ``metrics/<name>.py`` with ``read(reading) ->
  float | None``;
* a cell's limits for ``correct``: ``limits/<workload>.json``.

A cell, a configuration or a metric is added by adding files and
entries; no file that is there changes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one benchmark cell and print one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not a.seconds > 0:
        ap.error("--seconds must be positive")
    return a


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a fresh module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by its
    names."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    driver: Path
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    pkg = root / PKG.name
    traffic = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    return Cell(
        workload=w,
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=traffic,
        limits=load_json(pkg / "limits" / f"{name}.json"),
        driver=pkg / "drivers" / f"{traffic['driver']}.py",
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader_path(metric: str, root: Path = ROOT) -> Path:
    return root / PKG.name / "metrics" / f"{metric}.py"


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell and the run's arguments."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str


def process_start(now: float) -> float:
    """``now`` (``perf_counter``) less the age of this process, read from
    ``/proc`` (to a clock tick); ``now`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            started = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - started / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules(names) -> List[str]:
    """The names whose top-level part (before the first dot) is one of
    `FORBIDDEN`, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def checks_pass(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def finish(cell: Cell, outcome: dict, setup_s: float, trace: bool,
           device: dict, root: Path = ROOT) -> dict:
    """The result line of a run from a driver's ``outcome``: ``metrics``
    (the end-to-end values), ``attempted``, ``failed``, ``checks``
    (``{name: {"value", "limit"}}``), ``reading`` (what the per-layer
    readers read) and, traced, ``trace`` (`devtrace.summarize`)."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(reader_path(m["name"], root),
                                 "portbench_metric_" + m["name"]
                                 .replace(".", "_"))
            value = reader.read(outcome["reading"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(outcome["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = outcome["checks"]
    line = {"correct": bool(checks) and checks_pass(checks)
            and outcome["failed"] == 0,
            "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]),
            "metrics": metrics, "device": device}
    tr = outcome.get("trace")
    if trace and tr is not None:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    if outcome.get("card"):
        line["card"] = outcome["card"]
    line["checks"] = checks
    return line


def main(argv: Optional[List[str]] = None, t_top: Optional[float] = None
         ) -> int:
    t_top = time.perf_counter() if t_top is None else t_top
    t_start = process_start(t_top)
    a = parse_args(argv)
    cell = find_cell(a.workload)
    import torch
    chips = int(cell.workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: needs {chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    # one intra-op thread: no pool of spinning threads beside the loop
    torch.set_num_threads(1)
    driver = load_module(cell.driver, "portbench_driver")
    t_driver = time.perf_counter()
    outcome = driver.run(Run(cell=cell, seed=a.seed, seconds=a.seconds,
                             trace=bool(a.trace), device="cuda:0"))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    tr = outcome.get("trace")
    if a.trace:
        if tr is None:
            print("portbench: the trace holds no window", file=sys.stderr)
            return 4
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
    line = finish(cell, outcome, outcome["window_start"] - t_start,
                  bool(a.trace), device)
    info = dict(outcome.get("info", {}), before_driver_s=t_driver - t_start)
    print(json.dumps({"info": info}, default=str), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
