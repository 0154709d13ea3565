"""The cells at sizes a CPU test holds, and a driver run of one on the CPU (the harness's dry
path: everything ``run.py`` does after its look for a card)."""
from __future__ import annotations

import time

TINY = {
    "cheetah_cem_3x500.cem_closed_loop": {
        "config": {"model": {"hidden": [16, 16]}},
        "traffic": {"solver_kwargs": {"population": 40, "num_elite": 5, "max_iterations": 2},
                    "planning_horizon": 5, "trace_acts": 3}},
    "cheetah_cem_3x500.random_search": {
        "config": {"model": {"hidden": [16, 16]}},
        "traffic": {"solver_kwargs": {"population": 64}, "planning_horizon": 5,
                    "trace_acts": 3}},
    "pets_halfcheetah.ts_inf_closed_loop": {
        "config": {"model": {"hidden": [16, 16], "num_particles": 4}},
        "traffic": {"solver_kwargs": {"population": 20, "num_elite": 4, "max_iterations": 2},
                    "planning_horizon": 4, "trace_acts": 3}},
    "pets_halfcheetah.train": {
        "config": {"model": {"hidden": [16, 16]}},
        "traffic": {"replay": {"episodes": 2, "steps": 100}}},
}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds may be


def dry_run(workload: str, seed: int = SEED, trace: bool = False, control: bool = False,
            seconds: float = 0.3, bench_path=None, overrides=None):
    """``(run, outcome)`` of one tiny run of ``workload`` on the CPU."""
    import torch

    from port_bench import core

    torch.set_num_threads(1)
    kwargs = {} if bench_path is None else {"bench_path": bench_path}
    run = core.load_run(workload, seed, seconds, trace, "cpu", time.perf_counter(),
                        overrides=TINY[workload] if overrides is None else overrides,
                        **kwargs)
    run.extra["control"] = control
    return run, core.driver(run).drive(run)
