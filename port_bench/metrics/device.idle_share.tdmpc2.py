"""``device.idle_share.plan``, read in the TD-MPC2 cell, where it moves that cell's latency."""

from port_bench.core import metric_reader

read = metric_reader("device.idle_share.plan")
