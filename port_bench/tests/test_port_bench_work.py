"""The work counted from shapes, against counts by hand."""
import json
from pathlib import Path

import pytest

from port_bench import work

HERE = Path(__file__).resolve().parent.parent


def load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


CEM = load("configs", "cheetah_cem_3x500")
PETS = load("configs", "pets_halfcheetah")
# MACs per row and step of one member: 23*500 + 500*500*2 + 500*17 (the 3x500 net), and
# 24*200 + 200*200*3 + 200*36 (the 4x200 net with its mean and log-variance head).
CEM_MACS = 23 * 500 + 2 * 500 * 500 + 500 * 17
PETS_MACS = 24 * 200 + 3 * 200 * 200 + 200 * 36


@pytest.mark.parametrize("config, traffic, flops", [
    # 2 x MACs x 5 members x 1000 rows x H=50 x 5 iterations = 1.30 TFLOP.
    (CEM, "cem_closed_loop", 2 * CEM_MACS * 5 * 1000 * 50 * 5),
    # one member per row: 2 x MACs x (500 x 20 particles) rows x H=30 x 5 = 0.396 TFLOP.
    (PETS, "ts_inf_closed_loop", 2 * PETS_MACS * 500 * 20 * 30 * 5),
    # 2 x MACs x 5 members x 4048 rows x H=15, one rollout = 0.316 TFLOP.
    (CEM, "random_search", 2 * CEM_MACS * 5 * 4048 * 15),
])
def test_act_flops(config, traffic, flops):
    assert work.act_flops(config, load("traffic", traffic)) == pytest.approx(flops, rel=1e-12)


def test_the_flagship_counts():
    assert CEM_MACS == 520_000
    assert work.act_flops(CEM, load("traffic", "cem_closed_loop")) == pytest.approx(1.30e12)


def test_rollout_least_time():
    # One iteration: 2.6e11 FLOP at 67 TFLOP/s = 3.881 ms (PERF.md's 3.88 ms K2 bound); its
    # bytes (weights 10.4 MB, actions, states) take 3.5 us at 3.35 TB/s.
    per_iteration = 2 * CEM_MACS * 5 * 1000 * 50 / 67e12 * 1e3
    assert work.rollout_least_ms_per_act(CEM, load("traffic", "cem_closed_loop")) == \
        pytest.approx(5 * per_iteration, rel=1e-12)
    ms, bound_by = work.bound(work.shapes_of(CEM), 1000, 50, 5)
    assert bound_by == "operations" and ms == pytest.approx(3.8806, abs=1e-4)


def test_weight_bytes():
    # 5 members x (520 000 f32 weights + 1517 f32 biases) + 6 stats vectors of max(S, U).
    _, weight_bytes = work.mlp_work(work.shapes_of(CEM), 1, 1, 1)
    assert weight_bytes == 5 * (520_000 * 4 + 4 * (500 * 3 + 17)) + 4 * 6 * 17


def test_train_flops_per_step():
    # Forward: 2 x MACs x 32 rows x 5 members; backward twice that.
    assert work.train_flops_per_step(PETS, 32) == pytest.approx(3 * 2 * PETS_MACS * 32 * 5)


def test_least_ms_picks_the_binding_side():
    assert work.least_ms(67e12, 1.0, "float32") == (1e3, "operations")
    ms, side = work.least_ms(1.0, 3.35e12, "float32")
    assert side == "bytes" and ms == pytest.approx(1e3)
