"""The TD-MPC2 cell's own pieces: its driver on the dry path, faults planted in the program that
make ``correct`` false, the FLOPs counted from its shapes, and ``models.device_idle_ms_per_act.
tdmpc2`` on a synthetic window (``data/latent_spans_trace.json``, us: one ``act()`` whose first
evaluation runs eagerly, its steps' ``models.reward`` inside ``models.step``, then
``models.value``, and whose second replays a graph; 340 us of idle time)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import core, latent_work, spans, trace
from port_bench.tests.tiny import TINY, dry_run

CELL = "tdmpc2_317m.latent_closed_loop"
HERE = Path(__file__).resolve().parent
DATA = HERE / "data" / "latent_spans_trace.json"


def load(kind, name):
    return json.loads((HERE.parent / kind / f"{name}.json").read_text())


def correct(out) -> bool:
    return out.failed == 0 and all(c.ok for c in out.checks.values())


# --------------------------------------------------------------------------- the dry path

@pytest.mark.parametrize("traced", [False, True])
def test_dry_run_is_correct(traced):
    run, out = dry_run(CELL, trace=traced)
    assert correct(out), out.checks
    assert out.attempted > 0
    assert set(out.end_to_end) == {"act_ms_p50", "act_ms_p95", "agent_plans_per_s"}
    assert run.extra["answer_parts"].keys() == {"action", "carry", "lookahead"}
    assert out.end_to_end["act_ms_p50"] <= out.end_to_end["act_ms_p95"]
    if not traced:
        # As closed_loop.py's: every completed call over the whole window, which the last
        # call closes after --seconds.
        assert out.work["window_s"] >= run.seconds
        assert out.end_to_end["agent_plans_per_s"] == pytest.approx(
            out.attempted * run.traffic["agents"] / out.work["window_s"])
    if traced:
        assert out.attempted == run.traffic["trace_acts"]
        ctx = {"traced": out.traced, "work": out.work}
        names = {m["name"] for m in run.per_layer()}
        assert names == {"step.act_mfu.tdmpc2", "device.idle_share.tdmpc2",
                         "evaluator.graph_replay_share.tdmpc2",
                         "models.device_idle_ms_per_act.tdmpc2",
                         "solver.device_ops_per_act.tdmpc2", "policy.host_waits_per_act",
                         "policy.device_idle_ms_per_act", "solver.device_idle_ms_per_act",
                         "evaluator.device_idle_ms_per_act"}
        for name in names:
            core.metric_reader(name)(ctx)
        # The CPU runs no graph: every evaluation is eager.
        assert core.metric_reader("evaluator.graph_replay_share.tdmpc2")(ctx) == 0.0


def test_the_control_is_read():
    run, out = dry_run(CELL, control=True)
    assert correct(out)
    assert {"control_answer", "control_action", "control_lookahead"} <= set(out.readings)


def test_the_new_cells_are_driven_at_a_tiny_size():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    assert {w["name"] for w in bench["workloads"]} <= set(TINY)


# --------------------------------------------------------------------------- faults

@pytest.fixture
def latent_module():
    from blackbox_mpc_torch.models import latent

    return latent


def test_simnorm_over_the_wrong_axis(latent_module, monkeypatch):
    def strided(x, group):
        # Groups of units `group` apart instead of `group` neighbours.
        shape = x.shape
        g = x.reshape(*shape[:-1], group, -1)
        return torch.softmax(g, dim=-2).reshape(shape)

    monkeypatch.setattr(latent_module, "simnorm", strided)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_q_pair_not_averaged(latent_module, monkeypatch):
    def first_only(config, params, z, eps, pair):
        a = latent_module.pi(config, params, z, eps)
        return latent_module.q_values(config, params, z, a, pair)[0]

    monkeypatch.setattr(latent_module, "terminal_value", first_only)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


def test_the_discount_of_the_value_dropped(latent_module, monkeypatch):
    value = latent_module.LatentWorldModel.terminal_value
    horizon = load("traffic", "latent_closed_loop")["planning_horizon"]
    gamma = load("traffic", "latent_closed_loop")["discount"]

    def undiscounted(self, *args):
        # The evaluator multiplies by gamma^H: the value arrives undiscounted.
        return value(self, *args) / gamma**horizon

    monkeypatch.setattr(latent_module.LatentWorldModel, "terminal_value", undiscounted)
    out = dry_run(CELL)[1]
    assert not correct(out) and not out.checks["answer"].ok


# --------------------------------------------------------------------------- work

def test_head_macs_against_the_table():
    h = latent_work.head_macs(load("configs", "tdmpc2_317m"))
    # [obs 17, task 96] -> 4096 x 4 -> 1376; [z 1376, task 96, a 6] = 1478 in.
    assert h["encoder"] == 113 * 4096 + 3 * 4096 * 4096 + 4096 * 1376  # 56.4 M
    assert h["dynamics"] == 1478 * 4096 + 4096 * 4096 + 4096 * 1376  # 28.5 M
    assert h["reward"] == h["q"] == 1478 * 4096 + 4096 * 4096 + 4096 * 101  # 23.2 M
    assert h["pi"] == 1472 * 4096 + 4096 * 4096 + 4096 * 12  # 22.9 M
    total = h["encoder"] + h["dynamics"] + h["reward"] + h["pi"] + 8 * h["q"]
    assert total == 316_956_672  # the published 317M: its weight matrices


def test_act_flops_against_the_table():
    config, traffic = load("configs", "tdmpc2_317m"), load("traffic", "latent_closed_loop")
    # 3 x (dynamics + reward) + pi + 2 Q = 224.5 M MACs a candidate and iteration.
    assert latent_work.macs_per_row(config, 3) == 224_481_280
    # 2 x 224.5 M x 512 candidates x 6 iterations = 1.379 TFLOP; 20.6 ms at 67 TFLOP/s.
    flops = latent_work.act_flops(config, traffic)
    assert flops == 2 * 224_481_280 * 512 * 6
    assert flops == pytest.approx(1.379e12, rel=1e-3)
    assert flops / 67e12 * 1e3 == pytest.approx(20.6, abs=0.05)


# --------------------------------------------------------------------------- spans

IDLE_BY_SPAN = {
    "outside": 10.0 + 50.0,
    "policy.obs_in": 10.0 + 20.0,
    "models.encode": 10.0 + 10.0,
    "solver.sample": 10.0 + 10.0 + 5.0 + 5.0,
    "models.step": 10.0 + 5.0 + 10.0 + 5.0 + 10.0 + 10.0,
    "models.reward": 5.0 + 5.0 + 10.0 + 10.0,
    "models.value": 10.0 + 10.0,
    "evaluator.evaluate": 10.0 + 5.0 + 5.0,
    "evaluator.replay": 5.0 + 5.0,
    "solver.update": 5.0 + 5.0 + 5.0 + 5.0,
    "solver.solve": 10.0,
    "policy.lookahead": 10.0 + 10.0,
    "policy.wait": 5.0 + 15.0,
}


def latent_trace() -> trace.Traced:
    raw = json.loads(DATA.read_text())
    return trace.Traced([trace.Event(*e) for e in raw["events"]], *raw["window"])


def test_idle_time_split_over_the_model_spans():
    t = latent_trace()
    assert trace.device_busy_us(t) == pytest.approx(660.0)
    assert spans.idle_by_span(t) == pytest.approx(IDLE_BY_SPAN)
    assert sum(spans.idle_by_layer(t).values()) == pytest.approx(340.0)


@pytest.mark.parametrize("acts, ms", [(1, 0.12), (2, 0.06)])
def test_models_idle_per_act(acts, ms):
    # encode 20 + step 50 + reward 30 + value 20 us.
    read = core.metric_reader("models.device_idle_ms_per_act.tdmpc2")
    assert read({"traced": latent_trace(), "work": {"acts": acts}}) == pytest.approx(ms)


def test_replay_share_and_an_older_trace():
    read = core.metric_reader("evaluator.graph_replay_share.tdmpc2")
    assert read({"traced": latent_trace(), "work": {"acts": 1}}) == pytest.approx(50.0)
    t = latent_trace()
    t.events = [e for e in t.events if not e.name.startswith(spans._PREFIXES)]
    assert core.metric_reader("models.device_idle_ms_per_act.tdmpc2")(
        {"traced": t, "work": {"acts": 1}}) is None


# --------------------------------------------------------------------------- imports

def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_latent_path_loads_no_jax_and_the_reference_nothing_of_the_program():
    dry = _modules(f"""
import json, sys
from port_bench.tests.conftest import NEW
from port_bench.tests.tiny import dry_run
dry_run({CELL!r}, trace=True, overrides=NEW[{CELL!r}])
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
""")
    assert "blackbox_mpc_torch" in dry and not dry & set(core.JAX_MODULES)
    ref = _modules("""
import json, sys
import port_bench.reference.latent, port_bench.latent_work
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
""")
    assert "blackbox_mpc_torch" not in ref and not ref & set(core.JAX_MODULES)
