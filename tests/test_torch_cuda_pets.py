"""The PETS stack on the card: a sampled rollout on CUDA against the same rollout on the CPU,
and the host's waits of an eager ``act()`` with sampled propagation.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_pets.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models.dynamics import make_learned_dynamics, make_penalized_dynamics
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

pytestmark = pytest.mark.cuda

NET = dict(dim_s=6, dim_u=2, hidden=(64, 64), ensemble_size=5, probabilistic=True,
           learn_logvar_bounds=True)
CONFIGS = {
    "ts_inf": dict(propagation="ts_inf", num_particles=4),
    "mm": dict(propagation="mm", num_particles=4),
    "mean + penalty": dict(propagation="mean", plan_uncertainty_penalty=1.0),
}
POP, AGENTS, H = 64, 2, 10
MAX_SYNCS = 2  # the observation's copy in and the action's copy out


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the CPU reference runs in full f32
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def handler_on(device, label):
    config = LearnedDynamicsConfig(**NET, **CONFIGS[label])
    handler = DynamicsHandler(config, seed=0, device=device)
    g = np.random.default_rng(1)
    params = handler.dynamics_params.params
    params = {**params, "lv_min": torch.as_tensor(g.uniform(-8, -5, 6), dtype=torch.float32),
              "lv_max": torch.as_tensor(g.uniform(-2, 0, 6), dtype=torch.float32)}
    handler.set_params(handler.dynamics_params.replace(params=params))
    return handler


@pytest.mark.parametrize("label", list(CONFIGS))
def test_pets_rollout_cuda_matches_cpu(device, label):
    handler = handler_on(device, label)
    config, dp = handler.config, handler.dynamics_params
    penalized = config.plan_uncertainty_penalty > 0
    fn = make_penalized_dynamics(config) if penalized else make_learned_dynamics(config)[1]
    k = config.num_particles if config.propagation in ("ts_inf", "mm") else 1
    g = torch.Generator().manual_seed(0)
    s0 = torch.randn((AGENTS, 6), generator=g)
    acts = 2 * torch.rand((POP, AGENTS, H, 2), generator=g) - 1
    noise = torch.randn((H, POP * k * AGENTS, 6), generator=g) if k > 1 else None
    out = {}
    for where, params in (("cpu", dp.to("cpu")), ("cuda", dp)):
        on = torch.device("cpu") if where == "cpu" else device
        evaluate = make_trajectory_evaluator(
            lambda s, a, n=None, p=params: fn(p, s, a, n), reward, num_particles=k,
            dynamics_returns_penalty=penalized, device=on)
        out[where] = evaluate(s0.to(on), acts.to(on),
                              None if noise is None else noise.to(on)).cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= 1e-4 * max(1.0, float(out["cpu"].abs().max()))


@pytest.mark.parametrize("label", list(CONFIGS))
def test_eager_pets_act_waits_at_most_twice(device, label):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    handler = handler_on(device, label)
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), reward, handler, num_agents=AGENTS,
                       planning_horizon=H, population=POP, num_elite=8, max_iterations=3,
                       device=device)
    obs = np.zeros((AGENTS, 6), np.float32)
    policy.act(obs)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        action = policy.act(obs, exploration_noise=True)[0]
    syncs = sum(1 for e in prof.events()
                if e.name == "cudaStreamSynchronize" and e.device_type == DeviceType.CPU)
    assert syncs <= MAX_SYNCS
    assert np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)
