"""``solver.device_ops_per_act``, read in the TD-MPC2 cell, where it moves that cell's latency."""

from port_bench.core import metric_reader

read = metric_reader("solver.device_ops_per_act")
