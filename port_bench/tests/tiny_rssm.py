"""The RSSM cell at a size a CPU test holds: DreamerV3's layout at deter 64 in 8 blocks, hidden
and units 16, 4 codes of 4 classes, the published 255 reward bins, on cheetah-run's obs 17 and
action 6; PlaNet's CEM at population 64, 8 elites, 3 iterations, H=4. It is the smallest at
which each fault of ``test_port_bench_rssm.py`` moves a plan or a pick within the window."""

CELL = "dreamerv3_200m.planet_closed_loop"
SIZES = {
    "config": {"model": {"deter": 64, "hidden": 16, "stoch": 4, "classes": 4, "units": 16}},
    "traffic": {"solver_kwargs": {"population": 64, "num_elite": 8, "max_iterations": 3},
                "planning_horizon": 4, "trace_acts": 3},
}
