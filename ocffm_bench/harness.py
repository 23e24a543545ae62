"""The benchmark's harness: from a cell's name to the one result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the entry's ``file``): the sizes and the
  hyperparameters that the run uses;
- ``traffic/<traffic>.json``: the mix's parameters, with ``driver``
  naming the general code that runs it (``drivers/<driver>.py``);
- ``limits/<workload>.json``: the limit of each number that the cell's
  comparison with the plain reference gives;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``
  that takes one per-layer metric from the traced run.

A driver's ``run(ctx)`` makes the inputs from the seed, builds the
program, warms it up, measures the window, reads the peak memory, frees
the program and then judges what the window produced against the
reference (``reference/``).  It returns a ``DriverResult``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from . import trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "one_class_ffm_tpu")


@dataclass
class Context:
    """What a driver is given."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float  # perf_counter at process start: set-up runs from here
    spans: trace.Spans
    hooks: dict = field(default_factory=dict)  # the tests and
    # calibrate.py plant faults and controls here (each driver lists its)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class DriverResult:
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    run: Dict[str, Any]  # what the per-layer readers read; "digest": the
    # traced window's trace.digest, None without a trace


def root_of(bench_dir: str = BENCH_DIR) -> str:
    return os.path.dirname(bench_dir)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: dict, workload: str):
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[0]
    configs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if not configs:
        raise SystemExit(f"workload {workload!r} names no configuration")
    return cell, configs[0]


def cell_metrics(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones (a metric without ``workloads`` goes wherever its
    ``moves`` metric is reported)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "ocffm_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_context(workload: str, seed: int, seconds: float, traced: bool,
                 device, t_start: float, bench_dir: str = BENCH_DIR,
                 hooks: Optional[dict] = None):
    bench = load_json(os.path.join(root_of(bench_dir), "BENCHMARK.json"))
    cell, cfg_entry = find_cell(bench, workload)
    cfg = load_json(os.path.join(root_of(bench_dir), cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(bench_dir, "limits", workload + ".json"))
    ctx = Context(workload, cfg, traffic, limits, int(seed), float(seconds),
                  bool(traced), torch.device(device), t_start,
                  trace.Spans(traced), dict(hooks or {}))
    return bench, cell, ctx


def run_driver(ctx: Context) -> DriverResult:
    mod = importlib.import_module(
        f"ocffm_bench.drivers.{ctx.traffic['driver']}")
    return mod.run(ctx)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(device: torch.device, count: int, peak: int,
                digest: Optional[dict]) -> dict:
    if device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=count, memory_peak_bytes=int(peak))
    else:
        info = dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=int(peak))
    if digest is not None:
        info.update(busy_s=digest["busy_s"], window_s=digest["window_s"])
    return info


def result_line(bench: dict, ctx: Context, res: DriverResult) -> dict:
    """The result object: every metric this cell reports that was read,
    the device, and, last, the compared numbers with their limits."""
    metrics: Dict[str, dict] = {}
    digest = res.run.get("digest")
    for m in cell_metrics(bench, ctx.workload, ctx.traced):
        if ctx.traced:
            value = load_reader(m["name"])(res.run) \
                if digest is not None else None
        else:
            value = res.end_to_end.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    correct = bool(res.checks) and all(c.ok for c in res.checks) \
        and res.failed == 0
    out = dict(correct=correct, attempted=int(res.attempted),
               failed=int(res.failed), metrics=metrics,
               device=device_info(ctx.device, 1, res.memory_peak_bytes,
                                  digest))
    if digest is not None:
        out["breakdown"] = trace.breakdown(digest)
    out["checks"] = {c.name: dict(value=c.value, limit=c.limit)
                     for c in res.checks}
    return out


def check_lines(res: DriverResult) -> List[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in res.checks]

