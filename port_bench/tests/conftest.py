"""The tiny sizes of the cells that ``tiny.py``'s ``TINY`` does not name yet, registered in it
before the tests collect, so that every cell of ``BENCHMARK.json`` is driven on the dry path by
``test_port_bench_dry.py`` and the others.

TD-MPC2 at the CPU tests' size (``tests/test_torch_latent_model.py``): latent 16, widths 32,
3 encoder layers, 4 Q heads, 101 bins, task 8, obs 5, action 2; the weights' std is 0.2, so
that std x sqrt(width) is about the 317M model's 0.02 x sqrt(4096) and each head's output
moves with its input as much as at full size. Its population (128, 16 elites) is the smallest
at which each fault of ``test_port_bench_latent.py`` moves a plan within the window.
"""
from port_bench.tests.tiny import TINY

NEW = {
    "tdmpc2_317m.latent_closed_loop": {
        "config": {"model": {"obs_dim": 5, "action_dim": 2, "latent_dim": 16, "enc_dim": 32,
                             "mlp_dim": 32, "num_enc_layers": 3, "num_q": 4, "task_dim": 8},
                   "weights": {"std": 0.2}},
        "traffic": {"solver_kwargs": {"population": 128, "num_elite": 16,
                                      "max_iterations": 2},
                    "trace_acts": 3}},
}
for name, sizes in NEW.items():
    TINY.setdefault(name, sizes)
