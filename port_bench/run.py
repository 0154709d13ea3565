"""Runs one cell of ``BENCHMARK.json`` once, on the machine it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``blackbox_mpc_torch/``). It needs a CUDA
card (as many as the cell asks for) and exits with another code than 0, printing no result,
without one. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a traced window. The last line of standard output is the result; the last lines
of standard error are the numbers that decided ``correct``, each beside its limit.

The program's kernel and compiler caches go to ``.port_bench_cache/`` at the checkout's
root, so that only a cell's first run in a checkout builds.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".port_bench_cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, one CPU thread for the libraries' own
    pools (one process drives the card), and no JAX behind a library's back."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    for name, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                      ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[name] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _card() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable: {err}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be >= 0")
    _environment()
    from port_bench import core

    run = core.load_run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                        STARTED)
    if run.name not in {w["name"] for w in run.bench["workloads"]}:
        parser.error(f"{run.name} is a candidate cell, not in BENCHMARK.json: "
                     f"{run.workload['left_out']}; port_bench/control.py drives it")
    import torch

    chips = run.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run.mark("cuda_found")
    return report(run, chips, _card())


def report(run, chips: int, card: str) -> int:
    """Drives the cell and prints its result line; 3 where JAX was loaded."""
    import torch

    from port_bench import core, trace

    outcome = core.driver(run).drive(run)
    loaded = core.jax_modules()
    if loaded:
        print(f"port_bench: JAX modules loaded in the run's process: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes), "card": card}
    breakdown = None
    if run.trace:
        traced = outcome.traced
        device.update(busy_s=trace.device_busy_us(traced) / 1e6, window_s=traced.window_s)
        ctx = {"traced": traced, "work": outcome.work, "config": run.config,
               "traffic": run.traffic}
        metrics = {}
        for m in run.per_layer():
            value = core.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown(traced)
    else:
        # An end-to-end metric's quantity is its name up to the first dot: a suffix splits
        # a quantity between cells that hold it to different bounds (act_ms_p95.pets).
        values = dict(outcome.end_to_end, setup_s=run.extra["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"].split(".", 1)[0]], "unit": m["unit"]}
                   for m in run.end_to_end()}
    checks = dict(outcome.checks, failed_requests=core.Check(float(outcome.failed), 0.0))
    correct = all(c.ok for c in checks.values())
    print(json.dumps({"setup_parts_s": run.extra.get("setup_parts", {}),
                      "call_ms_deciles": run.extra.get("deciles"),
                      "answer_parts": run.extra.get("answer_parts")}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(core.result_line(correct, outcome.attempted, outcome.failed, metrics, device,
                           checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
