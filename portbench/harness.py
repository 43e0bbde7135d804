"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``),
the limits of its comparison ``limits/<cell>.json``, and each per-layer
metric a reader ``metrics/<metric>.py``. A driver module has

- ``prepare(run)`` -> state: makes the inputs from the seed, builds the
  program's objects, warms up every shape the window uses and runs the
  units that the comparison follows;
- ``unit(state)``: issues one unit of work (a frame, a step) as the window
  does;
- ``drain(state)``: waits for every unit issued;
- ``traced_hooks(state)``: a context manager that opens the harness's
  spans for the traced segment;
- ``host(state)``, ``counts(state)``, ``marks(state)``: what the per-layer
  readers read;
- ``check(run, state)`` -> {number: value}: frees the program's state and
  compares what it produced with the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "iffnerf_tpu")


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    dev: torch.device
    spec: dict
    t_start: float


@dataclasses.dataclass
class Measure:
    """What the per-layer readers read."""
    trace: object | None
    host: dict
    counts: dict
    marks: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_run(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
             dev, t_start: float) -> Run:
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Run(cell=cell, config=load_json(ROOT.parent / conf["file"]),
               traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
               limits=load_json(ROOT / "limits" / f"{cell}.json"),
               seed=seed, seconds=seconds, trace=trace, dev=torch.device(dev),
               spec=spec, t_start=t_start)


def driver(run: Run):
    return importlib.import_module(f"portbench.drivers.{run.traffic['driver']}")


def reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def execute(run: Run) -> dict:
    """Runs the cell -> the result line (a dict), its comparisons last."""
    drv = driver(run)
    state = drv.prepare(run)
    _sync(run.dev)
    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    units = 0
    while time.perf_counter() - t0 < run.seconds:
        drv.unit(state)
        units += 1
    drv.drain(state)
    _sync(run.dev)
    window_s = time.perf_counter() - t0

    trace = None
    if run.trace and run.dev.type == "cuda":
        from portbench.trace import traced

        n = run.traffic["trace_units"]

        def segment():
            for _ in range(n):
                drv.unit(state)
            drv.drain(state)

        with drv.traced_hooks(state):
            trace = traced(segment, n)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: "
                         f"{found}")
    peak = (torch.cuda.max_memory_allocated(run.dev)
            if run.dev.type == "cuda" else 0)
    attempted, failed = drv.tally(state)
    measure = Measure(trace=trace, host=dict(drv.host(state), window_s=window_s,
                                             units=units),
                      counts=drv.counts(state), marks=drv.marks(state))
    numbers = drv.check(run, state)
    checks = {}
    for name, limit in run.limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0

    metrics = {}
    if not run.trace:
        per_unit = window_s / units
        for m in run.spec["end_to_end"]:
            if not covers(m, run.cell):
                continue
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == run.traffic["end_to_end"]:
                value = (units / window_s if run.traffic["per"] == "rate"
                         else per_unit * 1e3)
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.spec["per_layer"]:
            if not covers(m, run.cell):
                continue
            value = reader(m["name"]).read(measure)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if run.dev.type == "cuda" else run.dev.type,
              "kind": (torch.cuda.get_device_name(run.dev)
                       if run.dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(),
                            "idle_gaps": trace.idle_gaps()}
    out["checks"] = checks
    return out


def check_lines(out: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in out["checks"].items()]
