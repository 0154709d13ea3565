"""``kernels.rollout_roofline``, read in the PETS controller's cell, where the rollout kernel
runs PETS' TS-infinity step and moves that cell's latency (``act_ms_p95.pets``). Nothing to
read where no rollout kernel ran (the eager path)."""

from port_bench.core import metric_reader

read = metric_reader("kernels.rollout_roofline")
