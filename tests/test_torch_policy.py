"""Port parity for the whole slice: ``MPCPolicy(device="cpu")`` of blackbox_mpc_torch over an
ensemble carried from the JAX package gives the JAX ``MPCPolicy``'s plan and expected reward
when both draw the same injected candidates; plus the constructor contract."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.solvers.cem as jcem
import blackbox_mpc_torch.solvers.cem as tcem
from blackbox_mpc_tpu.core.spaces import BoxSpace as JBox
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.policies.mpc_policy import MPCPolicy as JPolicy
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.parallel import make_pop_mesh

S, U, P, H, E = 4, 2, 32, 6, 2
SOLVER = dict(planning_horizon=H, population=P, num_elite=4, max_iterations=3)


def j_reward(s, a, ns):
    return ns[:, 0] - 0.1 * jnp.sum(jnp.square(a), axis=-1)


def t_reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


def bridged_handlers(propagation):
    jcfg = JConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=E, propagation=propagation)
    jh = JHandler(config=jcfg, seed=3)
    tcfg = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=E,
                                 propagation=propagation)
    th = DynamicsHandler(tcfg, device="cpu")
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu"))
    return jh, th


@pytest.mark.parametrize("backend,propagation", [("eager", "mean"), ("kernel", "mean"),
                                                 ("kernel", "ts1")])
def test_policy_matches_jax_on_injected_candidates(backend, propagation, monkeypatch, rng):
    z = np.clip(rng.normal(size=(P, 1, H, U)), -2, 2).astype(np.float32)
    monkeypatch.setattr(jcem, "truncated_normal",
                        lambda key, mean, std, shape: mean + jnp.asarray(z) * std)
    monkeypatch.setattr(tcem, "truncated_normal",
                        lambda gen, mean, std, shape: mean + torch.as_tensor(z) * std)
    jh, th = bridged_handlers(propagation)
    jp = JPolicy(JBox.of(-1.0, 1.0, dim=U), j_reward, jh, **SOLVER)
    tp = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, rollout_backend=backend,
                   device="cpu", **SOLVER)
    obs = rng.normal(size=S).astype(np.float32)
    jplan, jexp = jp.plan(obs)
    tplan, texp = tp.plan(obs)
    np.testing.assert_allclose(tplan, jplan, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(texp, jexp, rtol=1e-5, atol=1e-5)
    ja, jnext, jr = jp.act(obs)
    launches = rk.rollout_states.launches
    ta, tnext, tr = tp.act(obs)
    assert ta.shape == (U,) and tnext.shape == (S,) and np.ndim(tr) == 0
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tnext, jnext, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-5)
    # CPU tensors take the plain version: the kernel's launch count does not move.
    assert rk.rollout_states.launches == launches


def test_policy_closed_loop_actions_finite_and_bounded():
    th = DynamicsHandler(LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=E),
                         device="cpu")
    tp = MPCPolicy(BoxSpace.of(-0.5, 0.5, dim=U), t_reward, th, rollout_backend="kernel",
                   num_agents=3, device="cpu", **SOLVER)
    obs = np.zeros((3, S), np.float32)
    for t in range(3):
        action, obs, reward = tp.act(obs, t, exploration_noise=(t == 1))
        assert action.shape == (3, U) and obs.shape == (3, S) and reward.shape == (3,)
        assert np.all(np.isfinite(action)) and np.all(np.abs(action) <= 0.5)
    tp.reset()
    tp.switch_solver("CEM", population=16, num_elite=2)
    assert tp.act(obs)[0].shape == (3, U)


def test_constructor_errors(monkeypatch):
    space = BoxSpace.of(-1.0, 1.0, dim=U)
    th = DynamicsHandler(LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,)), device="cpu")
    true = DynamicsHandler(true_model=lambda s, a: s, device="cpu")

    def build(handler=th, **kw):
        return MPCPolicy(space, t_reward, handler, device="cpu", **kw)

    with pytest.raises(ValueError, match="rollout_backend"):
        build(rollout_backend="triton")
    # JAX's names are aliases of the port's
    assert build(rollout_backend="xla").rollout_backend == "eager"
    assert build(rollout_backend="auto").rollout_backend == "eager"  # no CUDA: eager
    # mesh= is ported: a one-device mesh builds, the kernel backend refuses any mesh
    assert build(mesh=make_pop_mesh(device="cpu")).mesh.size == 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        build(mesh=make_pop_mesh(device="cpu"), rollout_backend="kernel")
    with pytest.raises(ValueError, match="no choice of generator algorithm"):
        build(rng_impl="rbg")
    # "fused" and its alias build (their errors are in test_torch_fused_cem.py)
    for name in ("fused", "fused_cem"):
        assert build(rollout_backend=name, **SOLVER).solver_name == "CEM"
    with pytest.raises(ValueError, match="learned MLP"):
        build(true, rollout_backend="kernel")
    with pytest.raises(KeyError, match="available"):
        build(solver_name="bogus")
    for name in ("PSO", "SPSA", "Gradient", "CEM-GD"):  # every registry name builds
        assert build(solver_name=name, population=64, planning_horizon=4).solver_name == name
    for name in ("Gradient", "CEM-GD"):  # the rollout kernel has no backward
        with pytest.raises(ValueError, match="no VJP"):
            build(solver_name=name, rollout_backend="kernel")
    with pytest.raises(TypeError, match="population_size"):
        build(population_size=10)
    with pytest.raises(ValueError, match="num_elite"):
        build(population=10, num_elite=20)
    with pytest.raises(ValueError, match="action_smoothness_weight"):
        build(action_smoothness_weight=-1.0)
    with pytest.raises(ValueError, match="time_major"):
        build(rollout_backend="kernel", time_major=True)
    assert build(time_major=True)._config.time_major  # the eager evaluator takes it
    with pytest.raises(ValueError, match="keep_elites"):
        build(keep_elites=5, **SOLVER)  # more than num_elite
    with pytest.raises(ValueError, match="num_agents"):
        build(num_agents=2, **SOLVER).act(np.zeros((3, S), np.float32))
    with pytest.raises(RuntimeError, match="replay buffer is empty"):
        th.train()
    # The eager backend plans through a true model.
    assert build(true, **SOLVER).act(np.zeros(S, np.float32))[0].shape == (U,)
    # device=None means cuda: without CUDA it raises, never falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MPCPolicy(space, t_reward, th)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicsHandler(LearnedDynamicsConfig(dim_s=S, dim_u=U))
