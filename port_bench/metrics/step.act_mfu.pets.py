"""``step.act_mfu``, read in the PETS controller's cell, where it moves that cell's latency
(``act_ms_p95.pets``)."""

from port_bench.core import metric_reader

read = metric_reader("step.act_mfu")
