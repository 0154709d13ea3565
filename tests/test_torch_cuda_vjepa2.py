"""V-JEPA 2-AC (``blackbox_mpc_torch/models/vjepa2_ac.py``) on the card: ``act()``s whose
evaluations replay a CUDA graph against the same ``act()``s on the eager loop, bit for bit, with
the goal and the rows as the graph's inputs and the cache of earlier frames written in place;
the model's spans and counters, and the kernels ``models.attend`` launches against the names
``port_bench/metrics/models.attention_share.py`` reads; and one ``act()`` at the published
widths and the benchmark cell's sizes (a ViT-g encoder, the 300M predictor, CEM 128 x 10 elites
x 3 iterations at H = 2) against the cell's reference (``port_bench/reference/vjepa2_ac.py``:
no cache, each imagined frame from the predictor's forward over every frame before it), within
the cell's ``answer`` limit (``port_bench/limits/``), with the search of the elite sets that
rounding of the returns allows: the action, the plan's value, the one-step prediction, and the
chosen plan's last frame rolled out through the model's cache, element by element.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \\
        tests/test_torch_cuda_vjepa2.py -q
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import vjepa2_ac as vj
from blackbox_mpc_torch.rollout import evaluator

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CELL = "vjepa2_ac_300m.goal_cem_closed_loop"
# Images 64 x 64 (16 patches), 2 blocks 256 wide with 4 heads a stack.
MID = vj.VJEPA2ACConfig(image_size=64, enc_dim=256, enc_depth=2, enc_heads=4, enc_mlp_dim=1024,
                        pred_dim=256, pred_depth=2, pred_heads=4, pred_mlp_dim=1024)
H, POP, ELITES, ITERS, ACTS, BOUND = 2, 128, 10, 3, 4, 0.075


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def policy_on(model, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-BOUND, BOUND, dim=model.config.action_dim), model.reward_fn,
                     model, planning_horizon=H, population=POP, num_elite=ELITES,
                     max_iterations=ITERS, alpha=0.0, rollout_backend="auto", seed=5,
                     device=model.device, **kwargs)


def observations(config, n: int = ACTS) -> np.ndarray:
    g = np.random.default_rng(2)
    obs = g.uniform(0.0, 1.0, (n + 1, config.obs_dim)).astype(np.float32)
    obs[:, -config.state_dim:] = g.normal(0.0, 0.1, (n + 1, config.state_dim))
    return obs  # the last row's image is the goal


def acts(policy, obs) -> list:
    return [(*policy.act(o, t), policy._generator.get_state()) for t, o in enumerate(obs[:-1])]


def attention_names() -> tuple:
    path = ROOT / "port_bench" / "metrics" / "models.attention_share.py"
    spec = importlib.util.spec_from_file_location("attention_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.ATTENTION_KERNELS


def test_graphed_acts_equal_eager_bit_for_bit(device, monkeypatch):
    model = vj.VJEPA2ACWorldModel(MID, seed=3, device=device)
    obs = observations(MID)
    model.set_goal(obs[-1, :-MID.state_dim])
    graphed = policy_on(model)
    assert graphed.rollout_backend == "eager"
    got = acts(graphed, obs)
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        want = acts(policy_on(model), obs)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y)
    graphs = graphed.rollout_graphs
    assert (graphs.captures, graphs.replays, graphs.graphs) == (1, ACTS * ITERS - 1, 1)
    assert model.kv_cache_bytes == model.rollout_buffer_bytes() == (
        MID.pred_depth * 2 * POP * MID.frame_tokens * MID.pred_dim * 4)


def test_the_spans_counters_and_attention_kernels(device, tmp_path, monkeypatch):
    from torch.autograd import DeviceType

    from blackbox_mpc_torch.utils import profiling

    def traced(p, o, t):
        with profiling.trace(str(tmp_path / str(t))) as prof:
            p.act(o, t)
        return list(prof.profiler.kineto_results.events())

    def annotations(events):
        return [e.name() for e in events if e.is_user_annotation()
                and e.device_type() == DeviceType.CPU]

    model = vj.VJEPA2ACWorldModel(MID, seed=3, device=device)
    obs = observations(MID, 3)
    model.set_goal(obs[-1, :-MID.state_dim])
    frames = ITERS * H + 1  # the evaluations' and the lookahead's
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        events = traced(policy_on(model), obs[0], 0)
    eager = annotations(events)
    assert eager.count("models.predict") == frames and eager.count("models.step") == ITERS * H
    assert eager.count("models.attend") == MID.enc_depth + frames * MID.pred_depth
    assert eager.count("models.encode") == 1 and eager.count("models.value") == ITERS
    # Every kernel launched inside models.attend is one the metric's reader counts.
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.name() == "models.attend" and e.device_type() == DeviceType.CPU)
    launched = {e.correlation_id() for e in events if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()
                and any(a <= e.start_ns() <= b for a, b in spans)}
    # The device's operations only: a device-side user annotation may carry a like id.
    names = {e.name() for e in events if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation() and e.correlation_id() in launched}
    wanted = attention_names()
    assert names and all(any(k in n for k in wanted) for n in names), names
    assert (model.encodes, model.predicted_frames) == (1, frames)

    p = policy_on(model)
    p.act(obs[1], 1)  # the first evaluation eager, then the capture, then replays
    replayed = annotations(traced(p, obs[2], 2))
    assert replayed.count("evaluator.replay") == ITERS and "models.step" not in replayed
    assert replayed.count("models.predict") == 1  # the lookahead's
    assert model.encodes == 3 and model.goal_encodes == 1


def test_one_act_at_the_published_widths_against_the_reference(device):
    from port_bench.reference import precision
    from port_bench.reference import vjepa2_ac as reference

    config = vj.VJEPA2ACConfig()
    model = vj.VJEPA2ACWorldModel(config, seed=7, device=device)
    obs = observations(config, 2)
    model.set_goal(obs[-1, :-config.state_dim])
    p = policy_on(model)
    p.act(obs[0], 0)  # the first evaluation eager, then the capture
    state, gen_state = p._solver_state, p._generator.get_state()
    values, plans = [], []  # the solve's plan (its final mean) and the value it gave it
    solve = p._solve

    def keep(*args, **kwargs):
        out = solve(*args, **kwargs)
        values.append(out[2].expected_reward)
        plans.append(out[2].plan)
        return out

    p._solve = keep
    action, next_row, r = p.act(obs[1], 1)
    assert model.kv_cache_bytes == 6_492_782_592  # 24 x K, V x 128 x 258 x 1024 x 4 bytes
    assert p.rollout_graphs.replays == 2 * ITERS - 1 and r == 0.0
    x = torch.as_tensor(obs, device=device)
    with torch.no_grad():  # the chosen plan through the cache of earlier frames
        rolled = model.begin_rollout(model.encode(x[1:2]), H)
        for k in range(H):
            rolled = model.dynamics_fn(model.dynamics_params, rolled, plans[0][:, k])

    limit = json.loads((ROOT / "port_bench" / "limits" / f"{CELL}.json").read_text())["answer"]
    cfg = {"model": {k: getattr(config, k) for k in (
        "image_size", "patch_size", "tubelet_size", "enc_dim", "enc_depth", "enc_heads",
        "enc_mlp_dim", "pred_dim", "pred_depth", "pred_heads", "pred_mlp_dim", "action_dim",
        "state_dim", "ln_eps", "latent_eps")}, "action_bounds": [-BOUND, BOUND]}
    traffic = {"solver_kwargs": {"population": POP, "num_elite": ELITES, "alpha": 0.0,
                                 "max_iterations": ITERS}, "planning_horizon": H}
    ref = reference.Model(cfg, model.dynamics_params, device)
    size = config.image_size
    value = float(values[0][0])

    def gaps(a, v):
        """The action's gap (of the half range) and the plan value's from an outcome."""
        return (float(np.abs(a[0].cpu().numpy() - action).max()) / BOUND,
                abs(float(v[0]) - value) / max(1.0, abs(float(v[0]))))

    with precision("float32"):
        z0 = ref.encode(x[1:2, :-7].reshape(1, 3, size, size))
        goal = ref.encode(x[-1:, :-7].reshape(1, 3, size, size))[0]
        outcomes = reference.plan_step(
            ref, cfg, traffic, z0, x[1:2, -7:], goal, state.mean, state.variance, gen_state,
            accept=lambda a, final, v: max(gaps(a, v)) <= limit / 2)
        want_row = ref.lookahead(z0, x[1:2, -7:], torch.as_tensor(action, device=device)[None])
        want_last = ref.last_frame(z0, x[1:2, -7:], plans[0])

    def far(got, want):
        return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))

    assert min(max(gaps(a, v)) for a, _, v in outcomes) <= limit
    assert far(torch.as_tensor(next_row, device=device), want_row[0]) <= limit
    assert far(rolled.z, want_last) <= limit
