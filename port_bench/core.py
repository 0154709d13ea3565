"""What every cell shares: finding its files by name, the checks that decide ``correct``, the
result line, and the guards (the card, JAX).

A cell of ``BENCHMARK.json`` (or of ``candidates.json``, cells left out for now) names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix names its driver (``drivers/<driver>.py``, a
module with ``drive(run)``); the cell's limits are ``limits/<workload>.json``; a per-layer
metric ``<name>`` is read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["HERE", "ROOT", "JAX_MODULES", "Run", "Check", "load_run", "jax_modules",
           "metric_reader", "result_line"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that must not be loaded in a run's process: JAX and the JAX
# package (compared by whole top-level name: the port's name begins with the JAX package's).
JAX_MODULES = ("jax", "jaxlib", "flax", "blackbox_mpc_tpu", "benchmarks")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Check:
    """One number that decides ``correct``: it passes at or under its limit."""

    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # a NaN fails


@dataclass
class Run:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    bench: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # perf_counter at the process's start
    extra: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports."""
        reported = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            cells = m.get("workloads")
            if (self.name in cells) if cells is not None else (m["moves"] in reported):
                out.append(m)
        return out

    def mark(self, stage: str) -> None:
        """Seconds from the process's start to the end of a stage of set-up."""
        self.extra.setdefault("setup_parts", {})[stage] = time.perf_counter() - self.started

    def settle(self) -> None:
        """The end of set-up: what set-up made is collected and frozen out of the garbage
        collector's later passes, so that the window's collections walk only what the window
        makes; then ``setup_s`` is read."""
        gc.collect()
        gc.freeze()
        self.mark("warm")
        self.extra["setup_s"] = time.perf_counter() - self.started

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]


def load_run(workload: str, seed: int, seconds: float, trace: bool, device: str,
             started: float, bench_path: Path = ROOT / "BENCHMARK.json",
             overrides: dict | None = None) -> Run:
    """The cell ``workload`` of ``bench_path``, or of ``candidates.json`` (cells proven on the
    dry path and measured on the card that ``BENCHMARK.json`` leaves out, each with its
    reason), with its files. ``overrides`` (tests only): ``{"config": {...}, "traffic": {...}}``
    merged over the files' top-level keys (a nested ``model`` or ``solver_kwargs`` merged one
    level down)."""
    bench = _json(bench_path)
    cells = {**_json(HERE / "candidates.json"), **{w["name"]: w for w in bench["workloads"]}}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(w['name'] for w in bench['workloads'])}")
    cell = cells[workload]
    config = _json(HERE / "configs" / f"{cell['config']}.json")
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _json(HERE / "limits" / f"{cell['name']}.json")
    for target, changes in ((config, (overrides or {}).get("config", {})),
                            (traffic, (overrides or {}).get("traffic", {}))):
        for key, value in changes.items():
            if isinstance(value, dict) and isinstance(target.get(key), dict):
                target[key] = {**target[key], **value}
            else:
                target[key] = value
    return Run(cell, config, traffic, limits, bench, seed, seconds, trace, device, started)


def driver(run: Run):
    return importlib.import_module(f"port_bench.drivers.{run.traffic['driver']}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def jax_modules() -> list:
    """The loaded modules whose top-level name is one of JAX_MODULES."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(JAX_MODULES))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": c.value, "limit": c.limit} for name, c in checks.items()}
    return json.dumps(out)
