"""The V-JEPA 2-AC cell at a size a CPU test holds: images 32 x 32 (4 patches a frame), an
encoder and a predictor of 2 blocks 64 wide with 4 heads of 16, MLPs 256, the published 7-D
actions and states; the weights' std 0.08, so that std x sqrt(width) is the published 0.02 x
sqrt(1024); CEM at population 32, 4 elites, 3 iterations, H = 2, a new goal every 4 calls. It
is the smallest at which each fault of ``test_port_bench_vjepa2.py`` moves an answer within the
window. Imports nothing but the standard library."""

CELL = "vjepa2_ac_300m.goal_cem_closed_loop"
SIZES = {
    "config": {"model": {"image_size": 32, "enc_dim": 64, "enc_depth": 2, "enc_heads": 4,
                         "enc_mlp_dim": 256, "pred_dim": 64, "pred_depth": 2, "pred_heads": 4,
                         "pred_mlp_dim": 256},
               "weights": {"std": 0.08}, "scenes": {"coarse": 4}},
    "traffic": {"solver_kwargs": {"population": 32, "num_elite": 4, "max_iterations": 3},
                "reset_every": 4, "trace_acts": 3},
}
