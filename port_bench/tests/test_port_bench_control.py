"""On the card: at each cell's own size, on three seeds, the program's numbers stay within
the limits and the control (the reference in the nearest precision below the
configuration's, TF32 for float32, put in the program's place) breaks at least one of them;
for the training cell, so does each fault planted in the reference (half of each batch left
out; a state left unchanged). Skipped without a card; run on the GPU with
``python -m pytest -p no:cacheprovider -o addopts="" -m cuda port_bench/tests -q``."""
import pytest

from port_bench import core

CELLS = ["cheetah_cem_3x500.cem_closed_loop", "pets_halfcheetah.ts_inf_closed_loop",
         "pets_halfcheetah.train", "cheetah_cem_3x500.random_search"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_within_and_control_beyond_the_limits(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench.control import readings

    limits = core.load_run(workload, 0, 1.0, False, "cuda", 0.0).limits
    for seed, r in readings(workload, SEEDS, 1.0).items():
        assert all(v <= limits[k] for k, v in r["lower"].items()), (seed, r["lower"])
        control = {k[len("control_"):]: v for k, v in r["upper"].items()
                   if k.startswith("control_")}
        assert any(v > limits[k] for k, v in control.items() if k in limits), (seed, control)
        if workload.endswith(".train"):
            for fault in ("half_batch_", "unchanged_"):
                got = {k[len(fault):]: v for k, v in r["upper"].items() if k.startswith(fault)}
                assert any(v > limits[k] for k, v in got.items() if k in limits), \
                    (seed, fault, got)
