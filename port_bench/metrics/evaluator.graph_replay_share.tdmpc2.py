"""``evaluator.graph_replay_share.pets``'s count in the TD-MPC2 cell: 100 x the
``evaluator.replay`` spans over the ``evaluator.evaluate`` spans of the traced window, the share
of the latent world model's evaluations that replay a CUDA graph."""

from port_bench.core import metric_reader

read = metric_reader("evaluator.graph_replay_share.pets")
