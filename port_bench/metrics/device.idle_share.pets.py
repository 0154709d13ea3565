"""``device.idle_share.plan``, read in the PETS controller's cell, where it moves that cell's latency
(``act_ms_p95.pets``)."""

from port_bench.core import metric_reader

read = metric_reader("device.idle_share.plan")
