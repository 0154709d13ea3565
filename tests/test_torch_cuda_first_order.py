"""The rest of the solver registry and the pipeline on the card: ``adam_polish`` on CUDA against
the CPU, PSO and SPSA on ``"kernel"`` launching the rollout kernel (K2) once per iteration at P
and 2P rows, and a pipeline miss on ``"fused"`` giving the exact solve's bits.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \\
        tests/test_torch_cuda_first_order.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.policies.pipeline import SpeculativePipeline
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers.base import AdamState, adam_polish, adam_update

pytestmark = pytest.mark.cuda

NET = dict(dim_s=6, dim_u=2, hidden=(64, 64), ensemble_size=5)
POP, H, ITERS = 96, 10, 3
# The return's gradient, card against CPU, relative to its largest element; Adam's update from
# the same gradient, absolute.
GRAD_TOL, ADAM_TOL = 1e-3, 1e-6


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the CPU reference runs in full f32
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def handler_on(device):
    handler = DynamicsHandler(LearnedDynamicsConfig(**NET, propagation="mean"), seed=0,
                              device=device)
    return handler


def test_adam_polish_card_matches_cpu(device):
    """At every plan the card's polish visits: the gradient and Adam's update agree with the
    CPU's; the result is finite and in bounds."""
    handler = handler_on(device)
    dp, dyn = handler.dynamics_params, handler.dynamics_fn
    bounds = Bounds.of(-1.0, 1.0, dim=2)
    g = torch.Generator().manual_seed(0)
    plans = torch.rand((16, 2, H, 2), generator=g) * 1.8 - 0.9
    s0 = torch.randn((2, 6), generator=g)
    evaluate = {where: make_trajectory_evaluator(lambda s, a, p=p: dyn(p, s, a), reward,
                                                 device=where)
                for where, p in (("cpu", dp.to("cpu")), (device, dp))}
    points = []

    def objective(p):
        points.append(p.detach().clone())
        return evaluate[device](s0.to(device), p)

    out = adam_polish(objective, bounds, 0.1, plans.to(device), 10)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0
    states = {where: AdamState.zeros_like([plans.to(where)]) for where in ("cpu", device)}
    for here in points:
        grads = {}
        for where in ("cpu", device):
            leaf = here.to(where).requires_grad_(True)
            (grads[where],) = torch.autograd.grad(-evaluate[where](s0.to(where), leaf).mean(),
                                                  leaf)
        want = grads["cpu"]
        assert float((grads[device].cpu() - want).abs().max()) <= GRAD_TOL * float(
            want.abs().max())
        updates = {}
        for where in ("cpu", device):
            states[where], (updates[where],) = adam_update(states[where], [want.to(where)], 0.1)
        assert float((updates[device].cpu() - updates["cpu"]).abs().max()) <= ADAM_TOL


@pytest.mark.parametrize("name,rows", [("PSO", POP), ("SPSA", 2 * POP)])
def test_pso_and_spsa_launch_the_rollout_kernel(device, name, rows):
    handler = handler_on(device)
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), reward, handler, solver_name=name,
                       rollout_backend="kernel", planning_horizon=H, population=POP,
                       max_iterations=ITERS, device=device)
    obs = np.zeros(6, np.float32)
    policy.act(obs)
    counted, seen = rk.rollout_states, []

    def spy(config, ops, acts, s0, member):
        seen.append(acts.shape[1])
        return counted(config, ops, acts, s0, member)

    spy.launches = 0  # the wrapper counts through its module name, here the spy
    rk.rollout_states = spy
    try:
        action = policy.act(obs)[0]
    finally:
        rk.rollout_states = counted
    padded = -(-rows // rk.TILE_MEAN) * rk.TILE_MEAN
    assert seen == [padded] * ITERS
    assert np.isfinite(action).all() and np.abs(action).max() <= 1.0
    counted.launches = 0
    policy.act(obs)
    assert counted.launches == ITERS


def test_pipeline_miss_is_the_exact_solve_on_fused(device):
    """``spec_tol=0``: every step after the first a miss, solved again with the step's
    generators; the actions are the bits of the synchronous per-step-seeded run, and K4 and K6
    launch once per iteration of every solve."""
    steps = 5

    def policy():
        return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), reward, handler_on(device),
                         solver_name="CEM", rollout_backend="fused", num_agents=2,
                         planning_horizon=H, population=POP, num_elite=8, max_iterations=ITERS,
                         seed=3, device=device)

    obs0 = np.random.default_rng(0).normal(size=(2, 6)).astype(np.float32)
    exact, p = [], policy()
    pipe = SpeculativePipeline(p, spec_tol=None)
    pipe.reset()
    obs = torch.as_tensor(obs0, device=device)
    for t in range(steps):
        action, p._solver_state, _, _, _ = p._step(p._solver_state, obs, t,
                                                   *pipe.step_generators(t), False)
        exact.append(action.cpu().numpy())
        obs = obs + 0.01  # the "env": any observation that is not the prediction
    fc.fused_rollout.launches = fc.elite_moments.launches = 0
    pipe = SpeculativePipeline(policy(), spec_tol=0.0)
    pipe.reset()
    obs = obs0
    for t in range(steps):
        action, _, _, hit = pipe.act(obs, t)
        assert not hit
        np.testing.assert_array_equal(action, exact[t])
        obs = obs + 0.01
    assert pipe.misses == steps - 1
    assert fc.fused_rollout.launches == fc.elite_moments.launches == 2 * steps * ITERS
