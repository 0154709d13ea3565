"""The MBRL loop's use of the port's CUDA kernels, on the card.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_mbrl.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy, RandomPolicy
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models.analytic import pendulum_reward
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.workflows.rollouts import perform_rollouts

pytestmark = pytest.mark.cuda

# The pendulum at the flagship network width: S=3 and U=1 pad to widths of 4.
PENDULUM = dict(dim_s=3, dim_u=1, hidden=(500, 500, 500), ensemble_size=5)
AGENTS, POP, H = 2, 1000, 50  # 2000 rows: 42 tiles of 48, two waves of clusters


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version runs in full f32
    return torch.device("cuda", torch.cuda.current_device())


def trained_handler(device, hidden=(64, 64)):
    handler = DynamicsHandler(LearnedDynamicsConfig(**dict(PENDULUM, hidden=hidden)), seed=0,
                              device=device)
    env = NativePendulumVecEnv(num_envs=AGENTS, seed=0, max_episode_steps=30)
    result = perform_rollouts(env, RandomPolicy(env.action_space, num_agents=AGENTS),
                              rollout_horizon=30)
    obs = [o[:, e] for o in result["observations"] for e in range(AGENTS)]
    acts = [a[:, e] for a in result["actions"] for e in range(AGENTS)]
    handler.train(obs, acts, epochs=2, batch_size=32)
    return handler, env


def rel_err(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_train_then_act_repacks_operands(device, backend):
    handler, env = trained_handler(device)
    solver = dict(num_agents=AGENTS, rollout_backend=backend, planning_horizon=10, population=96,
                  num_elite=8, max_iterations=2, seed=3, device=device)
    policy = MPCPolicy(env.action_space, pendulum_reward, handler, **solver)
    obs = env.reset()
    rk.make_operands.calls = 0
    policy.act(obs)
    assert rk.make_operands.calls == 1
    before = handler.dynamics_params  # train() replaces the planning params, never mutates them
    handler.train(epochs=1, batch_size=32)
    action = policy.act(obs)[0]
    assert rk.make_operands.calls == 2  # the new weights were packed, once
    policy.act(obs)
    assert rk.make_operands.calls == 2
    # A twin policy that acts first on the old weights and then on the new ones, set by hand.
    twin_handler = DynamicsHandler(handler.config, device=device)
    twin_handler.set_params(before)
    twin = MPCPolicy(env.action_space, pendulum_reward, twin_handler, **solver)
    twin.act(obs)
    twin_handler.set_params(handler.dynamics_params)
    np.testing.assert_array_equal(action, twin.act(obs)[0])


def test_k2_pendulum_2000_rows_matches_plain(device):
    config = LearnedDynamicsConfig(**PENDULUM)
    handler = DynamicsHandler(config, seed=1, device=device)
    ops = rk.make_operands(handler.dynamics_params, config)
    g = torch.Generator(device=device).manual_seed(0)
    rows = AGENTS * POP
    rows_pad = -(-rows // rk.TILE_MEAN) * rk.TILE_MEAN
    acts = torch.rand((H, rows_pad, 1), generator=g, device=device) * 4 - 2
    s0 = torch.randn((rows_pad, 3), generator=g, device=device)
    states = rk.rollout_states(config, ops, acts, s0, None)[:, :rows]
    ref = rk.rollout_states_plain(config, ops, acts[:, :rows], s0[:rows], None)
    assert rel_err(states, ref) <= 1e-4


def test_k4_pendulum_2000_rows_matches_plain(device):
    config = LearnedDynamicsConfig(**PENDULUM)
    handler = DynamicsHandler(config, seed=2, device=device)
    ops = rk.make_operands(handler.dynamics_params, config)
    rows = AGENTS * POP
    rows_pad = -(-rows // rk.TILE_MEAN) * rk.TILE_MEAN
    s0 = torch.randn((AGENTS, 3), generator=torch.Generator(device=device).manual_seed(0),
                     device=device)
    mean = torch.zeros((AGENTS, H), device=device)
    std = torch.ones_like(mean)
    seed = torch.tensor([97531], dtype=torch.int32, device=device)
    states, actions = (o[:, :rows] for o in fc.fused_rollout(config, ops, s0, mean, std, seed,
                                                              rows_pad))
    ref_states, ref_actions = fc.fused_rollout_plain(config, ops, s0, mean, std, seed, rows)
    assert torch.equal(actions, ref_actions)
    assert rel_err(states, ref_states) <= 1e-4


def test_scatter_by_rank_same_mask_as_scalar_write(device):
    g = torch.Generator(device=device).manual_seed(0)
    rewards = torch.randn((POP, AGENTS), generator=g, device=device)
    _, idx = torch.topk(rewards.T, 50, dim=1)
    want = torch.zeros((POP, AGENTS), device=device)
    want[idx.T, torch.arange(AGENTS, device=device)[None, :]] = 1.0
    assert torch.equal(fc._scatter_by_rank(None, idx, POP), want)
    weights = torch.rand(POP, generator=g, device=device)
    order = torch.argsort(-rewards.T, dim=1, stable=True)
    want = torch.zeros((POP, AGENTS), device=device)
    want[order.T, torch.arange(AGENTS, device=device)[None, :]] = weights[:, None]
    assert torch.equal(fc._scatter_by_rank(weights, order, POP), want)
