"""``step.act_mfu``, read in the TD-MPC2 cell, where the FLOPs of an ``act()`` are the latent
world model's matrix products (``port_bench/latent_work.py::act_flops``: every candidate's H
steps of the dynamics and reward heads, then ``pi`` and two Q heads, over every iteration) and
the card's f32 peak is 67 TFLOP/s. No hand-written kernel runs there: this is the model step's
share of its roofline, which the TD-MPC2 cell's gemms, compute-bound, set."""

from port_bench.core import metric_reader

read = metric_reader("step.act_mfu")
