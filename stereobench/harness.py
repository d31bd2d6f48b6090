"""Resolve a cell of ``BENCHMARK.json`` by name, run it, print its line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name the manifest
gives it:

  * ``configs/<config>.json``: the sizes and settings of a configuration
    (the manifest's ``file``);
  * ``traffic/<mix>.json``: a mix's parameters; its ``loop`` names the
    driver in ``loops/`` that runs it, and :mod:`traffic.generator` makes
    every input;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(summary)``
    of a :class:`tracing.Summary`, returning None where it finds nothing;
  * ``limits/<cell>.json``: the limits of the numbers compared in a cell.

A loop returns an :class:`Outcome`; this module adds the per-layer
readings, the device's record and the checks, and prints the result as
the last line of standard output, the checks as the last lines of
standard error.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

from stereobench import checks, leastwork, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "custereomatching_tpu")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


class Run(NamedTuple):
    """One run of a cell, as the loops see it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float          # perf_counter() at process start


class Outcome(NamedTuple):
    setup_s: float
    values: Dict[str, float]            # end-to-end readings by name
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    stretch: Optional[tracing.Stretch]
    work: leastwork.Work                # least work of one traced unit
    frames_per_unit: int


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(manifest: dict, workload: str, base: Path = ROOT,
            home: Path = HERE) -> Cell:
    """The cell named ``workload``, its files read: the configuration's
    file relative to ``base``, the mix and the limits under ``home``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the manifest "
                       f"(known: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(base / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(home / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(home / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return Cell(name=workload, config=config, traffic=traffic,
                limits=limits, chips=int(w["chips"]),
                end_to_end=[m for m in manifest["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in manifest["per_layer"]
                           if _applies(m, workload)])


def loop(cell: Cell):
    """The driver module that runs the cell's traffic."""
    return importlib.import_module(f"stereobench.loops.{cell.traffic['loop']}")


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"stereobench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def stereo_config(config: dict):
    """The port's ``StereoConfig`` of a configuration file."""
    from custereomatching_tpu_torch.config import StereoConfig

    return StereoConfig(kernel_size=int(config["kernel_size"]),
                        num_disparities=config["num_disparities"],
                        softargmax_beta=float(config["softargmax_beta"]),
                        cost_threshold=float(config["cost_threshold"]),
                        epsilon=float(config["epsilon"]))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inflight:
    """Bounds the calls a host has queued ahead of the device: before the
    next call, wait for the one ``depth`` calls back."""

    def __init__(self, device: torch.device, depth: int):
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.events = []

    def push(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) >= self.depth:
            self.events.pop(0).synchronize()


def memory_peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(chips: int) -> torch.device:
    """The card a run measures; raises where there is none or too few."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: nothing is measured")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, started: float) -> dict:
    """Run a cell; the result line's object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` where traced, and
    last ``checks``)."""
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=trace, device=device, started=started)
    driver = loop(cell)
    mark(run, "harness imported")
    out: Outcome = driver.run(run)
    leftover = forbidden_modules()
    if leftover:
        raise SystemExit(f"forbidden modules loaded: {', '.join(leftover)}")
    metrics: Dict[str, dict] = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    breakdown = None
    if trace:
        out.stretch.close()
        peaks = (leastwork.peaks(dev["kind"]) if device.type == "cuda"
                 else None)
        summary = tracing.Summary(out.stretch.events, out.stretch.units,
                                  out.stretch.units * out.frames_per_unit,
                                  out.work, peaks)
        for m in cell.per_layer:
            value = reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        breakdown = summary.breakdown()
    else:
        values = dict(out.values, setup_s=out.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": out.failed == 0 and checks.verdict(out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = out.checks
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = None       # JSON has no NaN; the run is not correct
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def now() -> float:
    return time.perf_counter()


def mark(r: Run, what: str) -> None:
    """A set-up milestone on standard error, seconds from process start."""
    print(f"setup: {what} at {now() - r.started:.3f} s", file=sys.stderr)
