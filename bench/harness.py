"""The benchmark's engine, driven by data.

``BENCHMARK.json`` names the cells, configurations and metrics; each is
found by name under ``bench/``:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<traffic>.json``: a traffic mix, the parameters that the
  driver ``drivers/<kind>.py`` named by its ``kind`` reads;
- ``limits/<cell>.json``: the numbers that decide ``correct``, each with
  its limit;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
  where there is none, ``metrics/<metric up to its first dot>.py``, the
  reader that metrics of one quantity in several cells share;
- ``cost/<name>.py``: a kernel's or a model's work formula, ``cost(...)``;
- ``reference/<config>.py``: the configuration's plain reference.

A cell, a configuration or a metric is added as new files and entries;
no file here names one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of ``bench/`` by its file path (names may hold ``-`` and ``.``)."""
    name = "bench._by_path." + str(path.relative_to(BENCH)).replace("/", ".")[:-3]
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cost(name: str):
    """The work formula ``cost/<name>.py``."""
    return load_module(BENCH / "cost" / f"{name}.py")


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else the
    shared ``metrics/<metric up to its first dot>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path)


def reference(config: str):
    """The plain reference ``reference/<config>.py``."""
    return load_module(BENCH / "reference" / f"{config}.py")


def peaks() -> Dict[str, float]:
    """The H100 80GB HBM3's data-sheet peaks at 700 W (``hw.json``)."""
    return load_json(BENCH / "hw.json")


@dataclasses.dataclass
class CellSpec:
    """Everything a cell's run reads, found by name."""
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def cell_spec(name: str, bench: Optional[Dict] = None) -> CellSpec:
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    entry = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "workloads" / f"{entry['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if here(m) and m["moves"] in moved]
    return CellSpec(name, entry, config, traffic, limits, e2e, layer)


def driver(kind: str):
    """The traffic generator ``drivers/<kind>.py`` (a module of the package)."""
    return importlib.import_module(f"bench.drivers.{kind}")


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader sees: the cell, the traffic driver's
    counts of the work in the measured window, the program's counters over
    the traced steps, and their trace."""
    spec: CellSpec
    work: Dict[str, Any]
    counters: Dict[str, Any]
    trace: Any
    peaks: Dict[str, float]

    def cost(self, name: str):
        return cost(name)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """The numbers compared (those that the limits file names: a reading
    without a limit, PERF.md says why, is not compared) and whether each
    is finite and within its limit."""
    checks = {k: readings[k] for k in limits}
    return checks, all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", spec: Optional[CellSpec] = None,
        within=contextlib.nullcontext, readings: Optional[Dict] = None) -> Dict:
    """Run the cell ``name`` and return the result line (a dict). On the
    card, ``device`` is ``cuda``; tests pass ``cpu`` with a small ``spec``.
    ``within`` is entered around the program's part of the run (set-up,
    window, traced steps), not the reference's: the controls run the
    program under a lower precision through it. ``readings``, if given, is
    filled with every number the comparison worked out."""
    import torch

    spec = cell_spec(name) if spec is None else spec
    cell = driver(spec.traffic["kind"]).Cell(spec, seed, device)
    with within():
        cell.setup()
        _sync(device)
        setup_s = time.time() - t_start
        window = cell.window(seconds)
        summary = None
        if trace:
            from bench import devtrace

            summary = devtrace.traced(cell, lambda: _sync(device))
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that no run may load: {found}")
    cell.release()
    checks = cell.verify()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that no run may load: {found}")
    if readings is not None:
        readings.update(checks)
    checks, correct = judge(checks, spec.limits)
    if trace:
        ctx = Ctx(spec, window, summary.counters, summary, peaks())
        metrics = {}
        for m in spec.per_layer:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": window[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    line = {"correct": correct, "attempted": window["attempted"],
            "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = summary.breakdown()
    line["checks"] = {k: {"value": v, "limit": spec.limits[k]} for k, v in checks.items()}
    return line
