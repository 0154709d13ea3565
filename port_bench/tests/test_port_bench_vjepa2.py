"""The V-JEPA 2-AC cell's own pieces: its driver on the dry path, faults planted in the program
that make ``correct`` false, the FLOPs and cache counted from its shapes, its scenes, the
weights' layout, and ``models.attention_share`` on a synthetic window."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import core, trace, vjepa2_work
from port_bench.tests.tiny import TINY, dry_run
from port_bench.tests.tiny_vjepa2 import CELL, SIZES

HERE = Path(__file__).resolve().parent


def load(kind, name):
    return json.loads((HERE.parent / kind / f"{name}.json").read_text())


def correct(out) -> bool:
    return out.failed == 0 and all(c.ok for c in out.checks.values())


# --------------------------------------------------------------------------- the dry path

def test_the_tiny_size_is_registered():
    assert TINY[CELL] is SIZES


@pytest.mark.parametrize("traced", [False, True])
def test_dry_run_is_correct(traced):
    run, out = dry_run(CELL, trace=traced)
    assert correct(out), out.checks
    assert out.attempted > 0
    assert set(out.end_to_end) == {"act_ms_p50", "act_ms_p95", "agent_plans_per_s"}
    assert run.extra["answer_parts"].keys() == {"action", "energy", "lookahead", "rollout"}
    if traced:
        assert out.attempted == run.traffic["trace_acts"]
        names = {m["name"] for m in run.per_layer()}
        assert names == {"step.act_mfu", "device.idle_share.plan", "solver.device_ops_per_act",
                         "policy.host_waits_per_act", "policy.device_idle_ms_per_act",
                         "solver.device_idle_ms_per_act", "evaluator.device_idle_ms_per_act",
                         "models.device_idle_ms_per_act", "evaluator.graph_replay_share",
                         "models.attention_share"}
        ctx = {"traced": out.traced, "work": out.work}
        # The CPU launches no attention kernel of the card's: nothing to read.
        assert core.metric_reader("models.attention_share")(ctx) is None
    else:
        assert out.work["window_s"] >= run.seconds
        # A new goal every 4 calls: the window crosses episodes.
        assert out.attempted > run.traffic["reset_every"]


def test_the_control_is_read():
    _, out = dry_run(CELL, control=True)
    assert correct(out)
    assert {"control_answer", "control_action", "control_energy", "control_lookahead",
            "control_rollout"} <= set(out.readings)
    assert out.readings["control_answer"] > out.checks["answer"].limit


# --------------------------------------------------------------------------- faults

@pytest.fixture
def vj():
    from blackbox_mpc_torch.models import vjepa2_ac

    return vjepa2_ac


def test_rope_dropped(vj, monkeypatch):
    monkeypatch.setattr(vj, "rotate", lambda x, cos, sin: x)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_second_frame_attends_only_to_itself(vj, monkeypatch):
    block = vj._block

    def no_cache(x, blocks, i, heads, rope, eps, past=None, mask=None):
        return block(x, blocks, i, heads, rope, eps, None, mask)

    monkeypatch.setattr(vj, "_block", no_cache)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_action_token_dropped(vj, monkeypatch):
    tokens = vj._frame_tokens
    monkeypatch.setattr(vj, "_frame_tokens",
                        lambda config, pred, z, s, a: tokens(config, pred, z, s, a * 0.0))
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_state_not_integrated(vj, monkeypatch):
    def frozen(self, params, state, a, noise=None):
        if isinstance(state, vj.Rollout):
            z = vj.predict_frame(self.config, params, state.z, state.s, a, state.frame,
                                 state.cache)
            return vj.Rollout(z, state.s, state.frame + 1, state.cache)
        z, s = self._split(state)
        return torch.cat([vj.predict_frame(self.config, params, z, s, a).flatten(1), s], -1)

    monkeypatch.setattr(vj.VJEPA2ACWorldModel, "dynamics_fn", frozen)
    monkeypatch.setattr(vj.VJEPA2ACWorldModel, "mean_dynamics_fn", frozen)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_goal_not_encoded_again_at_a_reset(vj, monkeypatch):
    set_goal = vj.VJEPA2ACWorldModel.set_goal

    def first_only(self, image):
        if self.goal is None:
            set_goal(self, image)

    monkeypatch.setattr(vj.VJEPA2ACWorldModel, "set_goal", first_only)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_an_l2_energy(vj, monkeypatch):
    monkeypatch.setattr(vj, "goal_energy",
                        lambda z, goal: ((z - goal) ** 2).mean(dim=(-2, -1)))
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


# --------------------------------------------------------------------------- work

def test_act_flops_against_the_table():
    config, traffic = load("configs", "vjepa2_ac_300m"), load("traffic", "goal_cem_closed_loop")
    # A predictor block: qkv 3.15 M + projection 1.05 M + MLP 8.39 M multiply-adds a token.
    assert vjepa2_work.block_macs_per_token(1024, 4096) == 12_582_912
    # Frame 1: 258 tokens x 24 blocks, the embedding and read-out of 256 patches, 258 keys.
    f1 = vjepa2_work.frame_flops(config, 258)
    assert f1 == 2 * (14 * 1024 + 2 * 256 * 1408 * 1024 + 24 * (258 * 12_582_912
                                                              + 2 * 258 * 258 * 1024))
    assert f1 == pytest.approx(163.8e9, rel=1e-3)
    # Frame 2 attends to 516 keys through the cache: 13.1 GFLOP of attention.
    assert vjepa2_work.frame_flops(config, 516) - f1 == 2 * 24 * 2 * 258 * 258 * 1024
    assert vjepa2_work.candidate_flops(config, 2) == pytest.approx(334.2e9, rel=1e-3)
    assert vjepa2_work.encoder_flops(config) == pytest.approx(0.533e12, rel=1e-2)
    # 128 candidates x 3 iterations, the encoder and the lookahead: 129.0 TFLOP an act(),
    # 1.93 s at 67 TFLOP/s.
    flops = vjepa2_work.act_flops(config, traffic)
    assert flops == pytest.approx(128.3e12 + 0.533e12 + 0.164e12, rel=1e-3)
    assert flops / 67e12 == pytest.approx(1.925, abs=0.01)


def test_the_cache_and_the_weights_count():
    config = load("configs", "vjepa2_ac_300m")
    assert vjepa2_work.kv_cache_bytes(config, 128, 2) == 6_492_782_592  # 6.49 GB
    shapes = vjepa2_work.param_shapes(config)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

    assert round(count(shapes["encoder"]) / 1e6) == 1012
    assert round(count(shapes["predictor"]) / 1e6) == 305
    # The program's layout, leaf for leaf.
    from blackbox_mpc_torch.models import vjepa2_ac
    from port_bench.drivers.vjepa2_closed_loop import model_config

    assert shapes == vjepa2_ac.param_shapes(model_config(config))


def test_the_weights_law():
    from port_bench.drivers.vjepa2_closed_loop import make_weights

    config = dict(load("configs", "vjepa2_ac_300m"), model={
        **load("configs", "vjepa2_ac_300m")["model"], **SIZES["config"]["model"]})
    a, b = make_weights(config, 7, "cpu"), make_weights(config, 7, "cpu")
    w = a["predictor"]["blocks"]["fc1_w"]
    assert torch.equal(w, b["predictor"]["blocks"]["fc1_w"])
    assert float(w.abs().max()) <= 2.0 * 0.02 and abs(float(w.std()) - 0.02 * 0.88) < 2e-3
    assert torch.equal(a["encoder"]["norm_w"], torch.ones(64))
    assert not a["encoder"]["blocks"]["qkv_b"].any()


def test_the_scenes():
    from port_bench.drivers.vjepa2_closed_loop import Scenes

    config = load("configs", "vjepa2_ac_300m")
    one, two = Scenes(config, 5, 1), Scenes(config, 5, 1)
    row = one(3)
    assert row.shape == (1, 3 * 256 * 256 + 7) and row.dtype.name == "float32"
    assert (row[0, :-7] > 0).all() and (row[0, :-7] < 1).all()
    assert (two(3) == row).all() and not (one(4) == row).all()
    assert (one.goal(2) == two.goal(2)).all() and not (one.goal(2) == one.goal(3)).all()


# --------------------------------------------------------------------------- the metric

def test_attention_share_of_a_synthetic_window():
    ev = trace.Event
    events = [ev("port_bench.window", False, 0.0, 100.0, True),
              ev("fmha_cutlassF_f32_aligned_64x64_rf_sm80", True, 10.0, 30.0, False),
              ev("ampere_sgemm_128x64_nn", True, 30.0, 80.0, False),
              ev("fmha_cutlassF_f32_aligned_64x64_rf_sm80", True, 85.0, 95.0, False)]
    t = trace.Traced(events, 0.0, 100.0)
    assert core.metric_reader("models.attention_share")({"traced": t}) == pytest.approx(37.5)
    t.events = events[:1] + events[2:3]
    assert core.metric_reader("models.attention_share")({"traced": t}) is None


# --------------------------------------------------------------------------- imports

def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_path_loads_no_jax_and_the_reference_nothing_of_the_program():
    dry = _modules(f"""
import json, sys
from port_bench.tests.tiny import TINY
from port_bench.tests.tiny_vjepa2 import CELL, SIZES
from port_bench.tests.tiny import dry_run
dry_run(CELL, trace=True, overrides=SIZES)
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
""")
    assert "blackbox_mpc_torch" in dry and not dry & set(core.JAX_MODULES)
    ref = _modules("""
import json, sys
import port_bench.reference.vjepa2_ac, port_bench.vjepa2_work
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
""")
    assert "blackbox_mpc_torch" not in ref and not ref & set(core.JAX_MODULES)
    root = _modules("""
import json, sys
import conftest
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
""")
    assert not root & {"torch", "numpy", *core.JAX_MODULES}
