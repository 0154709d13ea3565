"""The RSSM cell's own pieces: its driver on the dry path at the tiny size of
``tiny_rssm.py`` (passed to ``tiny.dry_run`` here), faults planted in the program that make
``correct`` false, the FLOPs counted from its shapes, and the two base readers it adds
(``models.device_idle_ms_per_act``, ``evaluator.graph_replay_share``) on synthetic windows."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import core, rssm_work, trace
from port_bench.tests.tiny import dry_run
from port_bench.tests.tiny_rssm import CELL, SIZES

HERE = Path(__file__).resolve().parent


def load(kind, name):
    return json.loads((HERE.parent / kind / f"{name}.json").read_text())


def correct(out) -> bool:
    return out.failed == 0 and all(c.ok for c in out.checks.values())


def run(**kwargs):
    return dry_run(CELL, overrides=SIZES, **kwargs)


# --------------------------------------------------------------------------- the dry path

@pytest.mark.parametrize("traced", [False, True])
def test_dry_run_is_correct(traced):
    r, out = run(trace=traced)
    assert correct(out), out.checks
    assert set(out.checks) == {"start", "answer", "ties", "picks"}
    assert out.checks["ties"].value == 0 and out.checks["picks"].value == 0
    parts = r.extra["answer_parts"]
    assert {"action", "lookahead", "belief", "rerun"} <= set(parts)
    # Every evaluation of every sampled call followed the program's, and the re-run of each
    # call gave the window's action bit for bit.
    assert parts["followed"] == r.traffic["solver_kwargs"]["max_iterations"]
    assert parts["rerun"] == 0.0
    assert set(out.end_to_end) == {"act_ms_p50", "act_ms_p95", "agent_plans_per_s"}
    if traced:
        assert out.attempted == r.traffic["trace_acts"]
        names = {m["name"] for m in r.per_layer()}
        assert names == {"step.act_mfu", "device.idle_share.plan", "solver.device_ops_per_act",
                         "policy.host_waits_per_act", "policy.device_idle_ms_per_act",
                         "solver.device_idle_ms_per_act", "evaluator.device_idle_ms_per_act",
                         "models.device_idle_ms_per_act", "evaluator.graph_replay_share"}
        ctx = {"traced": out.traced, "work": out.work}
        for name in names:
            core.metric_reader(name)(ctx)
        # The CPU runs no graph: every evaluation is eager.
        assert core.metric_reader("evaluator.graph_replay_share")(ctx) == 0.0
    else:
        assert out.work["window_s"] >= r.seconds


def test_the_control_is_read_and_fails():
    r, out = run(control=True)
    assert correct(out)
    assert {"control_answer", "control_ties", "control_picks", "control_belief"} <= set(
        out.readings)
    # The reference in TF32, put in the program's place: its classes differ from the float32
    # reference's outside the tie margin.
    assert out.readings["control_picks"] > r.limits["picks"]


# --------------------------------------------------------------------------- faults

@pytest.fixture
def rssm():
    from blackbox_mpc_torch.models import rssm

    return rssm


def fails(out, *checks) -> bool:
    return not correct(out) and any(not out.checks[c].ok for c in checks)


def test_the_update_bias_dropped(rssm, monkeypatch):
    inner = rssm.block_linear

    def unbiased(x, layer):
        out = inner(x, layer)
        k = x.shape[-1]
        if out.shape[-1] == 3 * k:  # the gates [r, c, v]: v + 1, so s(v + 1 - 1)
            out = out + torch.cat([torch.zeros(2 * k), torch.ones(k)])
        return out

    monkeypatch.setattr(rssm, "block_linear", unbiased)
    assert fails(run()[1], "answer", "picks")


def test_unimix_left_out(rssm, monkeypatch):
    def pure(config, logits):
        return torch.softmax(logits.reshape(logits.shape[0], config.stoch, config.classes), -1)

    monkeypatch.setattr(rssm, "_code_probs", pure)
    assert fails(run()[1], "picks")


def test_a_fresh_draw_per_evaluation(rssm, monkeypatch):
    fresh = torch.Generator().manual_seed(5)

    def draws(self, generator, horizon, rows):
        return torch.rand((horizon, rows, self.config.stoch), generator=fresh)

    monkeypatch.setattr(rssm.RSSMWorldModel, "code_draws", draws)
    assert fails(run()[1], "picks")


def test_the_belief_not_carried(rssm, monkeypatch):
    inner = rssm.RSSMWorldModel.observe

    def forgetful(self, belief, obs, generator):
        zeros = rssm.Belief(torch.zeros_like(belief.feat), torch.zeros_like(belief.action))
        return inner(self, zeros, obs, generator)

    monkeypatch.setattr(rssm.RSSMWorldModel, "observe", forgetful)
    assert fails(run()[1], "answer")


def test_one_blocks_weights_shared_across_groups(rssm, monkeypatch):
    def shared(x, layer):
        w = layer["w"][:1].expand_as(layer["w"])
        return torch.baddbmm(layer["b"][:, None, :], x, w)

    monkeypatch.setattr(rssm, "block_linear", shared)
    assert fails(run()[1], "answer", "picks")


# --------------------------------------------------------------------------- work

def test_row_step_macs_against_the_table():
    config = load("configs", "dreamerv3_200m")
    macs = rssm_work.row_step_macs(config)
    # W0 8192 x 1024, W1 2048 x 1024, W2 6 x 1024: 10.5 M.
    assert macs["core_in"] == (8192 + 2048 + 6) * 1024
    # 8 x [4096 -> 1024] and 8 x [1024 -> 3072]: 58.7 M, 64 % of a row-step.
    assert macs["core_blocks"] == 8 * 4096 * 1024 + 8 * 1024 * 3072 == 58_720_256
    assert macs["prior"] == 8192 * 1024 + 1024 * 1024 + 1024 * 2048  # 11.5 M
    assert macs["reward"] == 10240 * 1024 + 1024 * 255  # 10.7 M
    total = sum(macs.values())
    assert total == 91_493_376 and round(macs["core_blocks"] / total, 2) == 0.64
    # The filter: the core, the encoder (17 -> 1024 -> 1024 -> 1024), the posterior.
    assert rssm_work.filter_macs(config) == (
        macs["core_in"] + macs["core_blocks"] + 17 * 1024 + 2 * 1024 * 1024
        + 9216 * 1024 + 1024 * 2048)


def test_act_flops_against_the_table():
    config, traffic = load("configs", "dreamerv3_200m"), load("traffic", "planet_closed_loop")
    # 1000 rows x 12 steps x 10 iterations = 120 000 row-steps of 91.49 M MACs, plus one
    # filter and one prediction: 21.96 TFLOP, 328 ms at 67 TFLOP/s.
    flops = rssm_work.act_flops(config, traffic)
    step = sum(rssm_work.row_step_macs(config).values())
    assert flops == 2 * (step * 120_000 + rssm_work.filter_macs(config) + step)
    assert flops == pytest.approx(21.96e12, rel=1e-3)
    assert flops / 67e12 * 1e3 == pytest.approx(327.7, abs=0.1)


def test_the_weights_follow_the_programs_layout():
    from blackbox_mpc_torch.models import rssm
    from port_bench.drivers import rssm_closed_loop as driver

    config = json.loads(json.dumps(load("configs", "dreamerv3_200m")))
    config["model"].update(SIZES["config"]["model"])
    weights = driver.make_weights(config, 2**33 + 1, "cpu")
    shapes = rssm.param_shapes(driver.model_config(config))
    assert {h: [{k: tuple(t.shape) for k, t in layer.items()} for layer in layers]
            for h, layers in weights.items()} == {
        h: [{k: tuple(s) for k, s in layer.items()} for layer in layers]
        for h, layers in shapes.items()}
    # Truncated at 2 std of a fan-in law, unit variance times 1 / fan_in after the cut.
    unit = torch.cat([(layer["w"] * math.prod(layer["w"].shape[:-1]) ** 0.5).reshape(-1)
                      for layers in weights.values() for layer in layers])
    assert float(unit.abs().max()) * driver.TRUNCATED_STD <= 2.0 + 1e-5
    assert float(unit.var()) == pytest.approx(1.0, rel=0.03)  # over 15 712 weights


# --------------------------------------------------------------------------- readers

def synthetic(spans: list, ops: list) -> trace.Traced:
    """A 100 us window: host spans and device operations as ``(name, start, end)``."""
    events = [trace.Event(n, False, a, b, True) for n, a, b in spans]
    events += [trace.Event(n, True, a, b, False) for n, a, b in ops]
    return trace.Traced(events, 0.0, 100.0)


def test_the_models_idle_time_counts_the_filter():
    t = synthetic([("policy.act", 0.0, 100.0), ("models.observe", 10.0, 30.0),
                   ("evaluator.evaluate", 40.0, 90.0), ("evaluator.replay", 45.0, 60.0)],
                  [("gemm", 0.0, 15.0), ("gemm", 25.0, 50.0), ("gemm", 55.0, 100.0)])
    read = core.metric_reader("models.device_idle_ms_per_act")
    assert read({"traced": t, "work": {"acts": 2}}) == pytest.approx(0.010 / 2)
    share = core.metric_reader("evaluator.graph_replay_share")
    assert share({"traced": t, "work": {"acts": 2}}) == pytest.approx(100.0)
    old = synthetic([], [("gemm", 0.0, 15.0)])
    assert read({"traced": old, "work": {"acts": 1}}) is None
    assert share({"traced": old, "work": {"acts": 1}}) is None


# --------------------------------------------------------------------------- imports

def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_rssm_path_loads_no_jax_and_the_reference_nothing_of_the_program():
    dry = _modules(f"""
import json, sys
from port_bench.tests.tiny import dry_run
from port_bench.tests.tiny_rssm import CELL, SIZES
dry_run(CELL, trace=True, overrides=SIZES)
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
""")
    assert "blackbox_mpc_torch" in dry and not dry & set(core.JAX_MODULES)
    ref = _modules("""
import json, sys
import port_bench.reference.rssm, port_bench.rssm_work, references.dreamerv3_rssm
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
""")
    assert "blackbox_mpc_torch" not in ref and not ref & set(core.JAX_MODULES)
