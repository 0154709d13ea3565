"""``workflows/device_episode.py::evaluate_solver_on_model`` against the JAX package's, and
``utils/profiling.py``. A deterministic stub solver over the analytic pendulum holds the loop
itself (1e-5 relative over 30 steps: float32 through the two packages' pendulum steps); the
fused CEM over a small learned model holds it with a solver whose counter RNG is fed one seed
on both sides (1e-4: float32 sums in other orders, through a closed loop of 3 steps)."""
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.pallas_cem as jc
import blackbox_mpc_torch.ops.fused_cem as tc
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.core.types import Solver as JSolver
from blackbox_mpc_tpu.core.types import SolverAux as JAux
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.analytic import pendulum_dynamics as j_pendulum
from blackbox_mpc_tpu.models.analytic import pendulum_reward as j_pendulum_reward
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.solvers.cem import CEMConfig as JCEMConfig
from blackbox_mpc_tpu.workflows.device_episode import evaluate_solver_on_model as j_episode
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import CEMConfig, make_cem
from blackbox_mpc_torch.utils import profiling
from blackbox_mpc_torch.workflows import evaluate_solver_on_model

torch.set_num_threads(1)

OBS0 = np.array([[-1.0, 0.0, 0.0], [0.6, 0.8, -1.5]], np.float32)
SEED = 2**31 - 3


def j_stub():
    """A PD controller with a step counter as its state: no randomness."""
    def solve(state, obs, t, key):
        action = jnp.clip(-2.0 * obs[:, 1:2] - 0.5 * obs[:, 2:3] + 0.01 * state[:, None],
                          -2.0, 2.0)
        return action, state + 1.0, JAux(expected_reward=state, plan=action[:, None])

    return JSolver(init=lambda key: jnp.zeros(2), solve=solve, reset=lambda s, key: s)


def t_stub():
    def solve(state, obs, t, generator):
        action = torch.clamp(-2.0 * obs[:, 1:2] - 0.5 * obs[:, 2:3] + 0.01 * state[:, None],
                             -2.0, 2.0)
        return action, state + 1.0, SolverAux(expected_reward=state, plan=action[:, None])

    return Solver(init=lambda g: torch.zeros(2, device=g.device), solve=solve,
                  reset=lambda s, g: s)


def test_stub_solver_episode_matches_jax():
    j_rewards, j_final, j_state = j_episode(j_stub(), j_pendulum, j_pendulum_reward,
                                            jnp.asarray(OBS0), 30, jax.random.PRNGKey(0))
    rewards, final, state = evaluate_solver_on_model(
        t_stub(), pendulum_dynamics, pendulum_reward, torch.as_tensor(OBS0), 30,
        torch.Generator())
    assert rewards.shape == (30, 2) and final.shape == (2, 3)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(j_rewards), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(state.numpy(), np.asarray(j_state))


def test_zero_steps_and_given_state():
    rewards, final, state = evaluate_solver_on_model(
        t_stub(), pendulum_dynamics, pendulum_reward, torch.as_tensor(OBS0), 0,
        torch.Generator(), solver_state=torch.full((2,), 5.0))
    assert rewards.shape == (0, 2) and torch.equal(final, torch.as_tensor(OBS0))
    assert torch.equal(state, torch.full((2,), 5.0))


def test_eager_cem_episode_is_the_policy_loop():
    """The eager CEM over the analytic pendulum: the episode equals a loop of MPCPolicy
    solves fed the model's next state, drawing from the same generator (bit for bit)."""
    config = CEMConfig(planning_horizon=8, population=32, num_elite=4, max_iterations=2,
                       num_agents=2)
    solver = make_cem(config, Bounds.of(-2.0, 2.0, dim=1),
                      make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device="cpu"))
    rewards, final, _ = evaluate_solver_on_model(
        solver, pendulum_dynamics, pendulum_reward, torch.as_tensor(OBS0), 5,
        torch.Generator().manual_seed(4))
    policy = MPCPolicy(BoxSpace.of(-2.0, 2.0, dim=1), pendulum_reward,
                       DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                       num_agents=2, planning_horizon=8, population=32, num_elite=4,
                       max_iterations=2, seed=4, device="cpu")
    obs = OBS0
    for t in range(5):
        action, next_obs, reward = policy.act(obs, t)
        np.testing.assert_array_equal(reward, rewards[t].numpy())
        obs = next_obs
    np.testing.assert_array_equal(obs, final.numpy())


def test_fused_cem_episode_matches_jax(monkeypatch):
    """The fused CEM (plain versions of K3, K4 and K6 on the CPU; JAX's kernels in interpret
    mode) over a small learned ensemble that is also the episode's env, each solve's seed
    patched to one value on both sides."""
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(SEED))
    monkeypatch.setattr(tc, "draw_seed", lambda generator: torch.tensor([SEED], dtype=torch.int32))
    jcfg = JConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2)
    jh = JHandler(config=jcfg, seed=3)
    tcfg = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2)
    dp = jh.dynamics_params
    tdp = dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu")
    kw = dict(planning_horizon=4, num_agents=2, population=64, num_elite=8, max_iterations=2)
    js = jc.make_fused_cem(JCEMConfig(**kw), JBounds.of(-2.0, 2.0, dim=1), jcfg, dp,
                           j_pendulum_reward, tile=8, interpret=True)
    ts = tc.make_fused_cem(CEMConfig(**kw), Bounds.of(-2.0, 2.0, dim=1), tcfg, tdp,
                           pendulum_reward, tile=8)
    j_dyn = jh.mean_dynamics_fn
    j_rewards, j_final, _ = j_episode(js, lambda s, a: j_dyn(dp, s, a), j_pendulum_reward,
                                      jnp.asarray(OBS0), 3, jax.random.PRNGKey(0))
    jax.effects_barrier()
    t_dyn = DynamicsHandler(tcfg, device="cpu").mean_dynamics_fn
    rewards, final, _ = evaluate_solver_on_model(
        ts, lambda s, a: t_dyn(tdp, s, a), pendulum_reward, torch.as_tensor(OBS0), 3,
        torch.Generator())
    np.testing.assert_allclose(rewards.numpy(), np.asarray(j_rewards), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), rtol=1e-4, atol=1e-4)


def test_profiling_writes_a_trace(tmp_path):
    """``profile_policy_solve`` traces a few ``act()``s and writes one Chrome trace under the
    directory; ``trace`` hands back the profiler, whose events name the policy's work."""
    policy = MPCPolicy(BoxSpace.of(-2.0, 2.0, dim=1), pendulum_reward,
                       DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                       planning_horizon=4, population=16, num_elite=4, max_iterations=1,
                       device="cpu")
    assert profiling.profile_policy_solve(policy, OBS0[0], str(tmp_path), steps=2) == str(
        tmp_path)
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("topk" in e.get("name", "") for e in events)
    with profiling.trace(str(tmp_path / "again")) as prof:
        policy.act(OBS0[0])
    assert any("topk" in e.name for e in prof.events())
    assert len(glob.glob(str(tmp_path / "again" / "*.json"))) == 1


@pytest.mark.parametrize("steps", [1, 4])
def test_episode_rewards_shape(steps):
    rewards, final, _ = evaluate_solver_on_model(
        t_stub(), pendulum_dynamics, pendulum_reward, torch.as_tensor(OBS0), steps,
        torch.Generator())
    assert rewards.shape == (steps, 2) and torch.isfinite(rewards).all()
