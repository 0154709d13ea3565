"""The benchmark of blackbox_mpc_torch, the PyTorch and CUDA port, on one NVIDIA GPU.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one
cell of the root ``BENCHMARK.json`` once and prints one JSON result line. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model, its weights' law, its normalizer's scale and reward;
* ``traffic/<mix>.json``: the driver (``drivers/<driver>.py``) and its parameters;
* ``metrics/<metric>.py``: the reader of one per-layer metric (``read(ctx)``);
* ``limits/<workload>.json``: the limits of the numbers that decide ``correct``.

The yardstick lives here too: the work counted from shapes (``work.py``), the trace's
reduction (``trace.py``), the statistics (``stats.py``), the inputs made from the seed
(``streams.py``) and the plain references (``reference/``), which import nothing of the
program. Nothing here imports JAX or the JAX package.
"""
