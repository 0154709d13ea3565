"""The readings that the limits of ``correct`` are set from, for one cell, on the card.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: the cell's set-up and a short window at its own load (as
``run.py`` drives it), then the program's numbers against the reference (the lower
readings) and the control's: the reference in the nearest precision below the
configuration's (TF32 for float32), put in the program's place, against the reference; for
a training cell also the faults planted in the reference (half of each batch left out; a
state left unchanged). One JSON line per seed, then the largest lower and the smallest upper
reading of each number. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from port_bench.run import _card, _environment  # noqa: E402


def readings(workload: str, seeds: list, seconds: float, device: str = "cuda",
             overrides=None) -> dict:
    """``{seed: {"lower": {...}, "upper": {...}}}``; each line is printed as it comes."""
    from port_bench import core

    out = {}
    for seed in seeds:
        run = core.load_run(workload, seed, seconds, False, device, time.perf_counter(),
                            overrides=overrides)
        run.extra["control"] = True
        outcome = core.driver(run).drive(run)
        out[seed] = {"lower": {k: c.value for k, c in outcome.checks.items()},
                     "upper": outcome.readings, "attempted": outcome.attempted,
                     "setup_s": run.extra["setup_s"], **outcome.end_to_end}
        print(json.dumps({"workload": workload, "seed": seed, **out[seed]}), flush=True)
    return out


def summary(per_seed: dict) -> dict:
    lower, upper = {}, {}
    for r in per_seed.values():
        for k, v in r["lower"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in r["upper"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
    return {"lower_max": lower, "upper_min": upper}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    _environment()
    import torch

    if not torch.cuda.is_available():
        print("port_bench: no CUDA card", file=sys.stderr)
        return 2
    per_seed = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds)
    print(json.dumps({"workload": args.workload, "card": _card(), **summary(per_seed)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
