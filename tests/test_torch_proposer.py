"""Port parity for the POPLIN-style proposer (``learning/proposer.py``), its bridge
(``models/convert.py::proposer_from_numpy``, ``load_legacy_npy``) and the policy's
``proposer=`` seeding, against the JAX package.

Tolerances: ``act`` and the plan proposal from converted params 1e-6; two epochs of behaviour
cloning from the same params and seed, losses and params rtol 1e-5 (atol 1e-6), Adam's first
moment rtol 1e-5 (atol 1e-5 of its largest element). The committed
checkpoint ``benchmarks/ckpt_gradient_bc_300``: its proposer is read by JAX's Orbax restore with
JAX's own template (the widths read from the checkpoint's metadata), converted, and held against
JAX's on states of its replay over its converted handler: ``act`` and each step of the H=15
proposal from JAX's state 1e-5, the free-running proposal ``FREE_RUNNING_TOL``; a Gradient
solve seeded by it, fed JAX's restarts and proposal: at each plan it visits the gradient
``GRAD_TOL`` of its scale and Adam's update from the same gradient 1e-6 (free running, 20 Adam steps
through this model spread float32 differences to 2e-2 of a plan, measured against JAX on the
CPU, so the parts are held one step at a time).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blackbox_mpc_torch.solvers.gradient as tgrad
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.learning import proposer as jprop
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.analytic import pendulum_dynamics as j_pendulum
from blackbox_mpc_tpu.rollout.evaluator import make_trajectory_evaluator as j_evaluator
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.learning import PolicyProposer, ProposerConfig
from blackbox_mpc_torch.learning.proposer import make_plan_proposal_fn, make_proposer_apply
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import (
    handler_from_numpy,
    load_legacy_npy,
    proposer_from_numpy,
)
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import base as tbase

CKPT = Path(__file__).resolve().parents[1] / "benchmarks" / "ckpt_gradient_bc_300"
LEARNING_RATE = 3e-3  # the committed run's (benchmarks/cheetah_mbrl.py)
STEP_TOL = 1e-5
# The committed model is expansive: a proposal step agrees to 5e-7 from JAX's own state, and
# the gap of a free-running unroll grows about 1.5x a step (measured: 3.0e-4 of the actions,
# which lie in [-1, 1], at H=15).
FREE_RUNNING_TOL = 1e-3
# The return's gradient at the same plans, relative to its largest element: backpropagation
# runs through the 15 steps of the same expansive model, so its float32 differences grow as the
# free-running unroll's do (measured 1.0e-4); Adam's update from the same gradients (at most a
# few lr = 0.1).
GRAD_TOL, ADAM_TOL = 1e-3, 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def pair(hidden=(16, 16), seed=0, dim_s=3, dim_u=1, low=-2.0, high=2.0):
    """A JAX proposer and the port's holding its state (the port's rng seeded alike)."""
    jp = jprop.PolicyProposer(jprop.ProposerConfig(dim_s=dim_s, dim_u=dim_u, hidden=hidden),
                              JBounds.of(low, high, dim=dim_u), seed=seed)
    tp = proposer_from_numpy(jp.state_dict(), ProposerConfig(dim_s=dim_s, dim_u=dim_u,
                                                             hidden=hidden),
                             Bounds.of(low, high, dim=dim_u), device="cpu")
    return jp, tp


class Pairs:
    """The part of a replay buffer that behaviour cloning reads."""

    def __init__(self, states, actions):
        self.states, self.actions = states, actions

    def arrays(self, validation=False):
        return self.states, self.actions, self.states


def expert_pairs(n=300, seed=0, noise=0.8):
    """A smooth expert on states in [-1, 1]^3, with exploration noise that reaches beyond the
    bounds (the targets are clipped)."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    act = (-2.4 * obs[:, 2:3] - 0.8 * obs[:, 1:2] + rng.normal(0, noise, (n, 1))).astype(
        np.float32)
    return Pairs(obs, act)


def test_act_and_plan_proposal_match_jax(rng):
    jp, tp = pair(seed=3)
    obs = rng.uniform(-3, 3, (9, 3)).astype(np.float32)
    close(tp.act(obs), jp.act(obs), 1e-6)
    horizon = 7
    jpropose = jprop.make_plan_proposal_fn(jp.config, jp.bounds,
                                           lambda dp, s, a: j_pendulum(s, a), horizon)
    tpropose = make_plan_proposal_fn(tp.config, tp.bounds,
                                     lambda dp, s, a: pendulum_dynamics(s, a), horizon)
    want = jpropose(jp.params, None, jnp.asarray(obs[:2]))
    got = tpropose(tp.params, None, torch.as_tensor(obs[:2]))
    assert got.shape == (2, horizon, 1)
    close(got, want, 1e-6)


def test_train_matches_jax(rng):
    jp, tp = pair(hidden=(32, 32))
    replay = expert_pairs()
    jstats = jp.train(replay, epochs=2, batch_size=64)
    tstats = tp.train(replay, epochs=2, batch_size=64)
    assert tstats["num_pairs"] == jstats["num_pairs"] == 300
    np.testing.assert_allclose(tstats["bc_loss"], jstats["bc_loss"], rtol=1e-5)
    state = tp.state_dict()
    jstate = jp.state_dict()
    for t_layer, j_layer in zip(state["params"], jstate["params"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(t_layer[k][0].numpy(), j_layer[k], rtol=1e-5, atol=1e-6)
    adam = jstate["opt_state"][0]
    assert state["adam"]["step"] == int(adam.count)
    flat = [layer[k] for layer in adam.mu for k in ("w", "b")]
    for got, want in zip(state["adam"]["exp_avg"], flat):
        # A moment sums gradients: elements near 0 are held to 1e-5 of the tensor's scale.
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_behaviour_cloning_fits_and_respects_bounds():
    tp = PolicyProposer(ProposerConfig(dim_s=3, dim_u=1, hidden=(32, 32)),
                        Bounds.of(-2.0, 2.0, dim=1), device="cpu")
    replay = expert_pairs(512, noise=0.0)
    target = np.clip(replay.actions, -2, 2)
    assert np.abs(replay.actions).max() > 2.0
    before = float(np.mean(np.square(tp.act(replay.states) - target)))
    tp.train(replay, epochs=60, batch_size=128)
    after = float(np.mean(np.square(tp.act(replay.states) - target)))
    assert after < 0.05 and after < before / 10, (before, after)
    out = tp.act(np.random.default_rng(1).uniform(-50, 50, (256, 3)))
    assert np.all(out >= -2.0) and np.all(out <= 2.0)
    assert tp.train(Pairs(np.zeros((0, 3), np.float32), np.zeros((0, 1), np.float32)))[
        "num_pairs"] == 0


def test_state_dict_round_trip(tmp_path):
    _, p1 = pair()
    p1.train(expert_pairs(128), epochs=3, batch_size=64)
    torch.save(p1.state_dict(), tmp_path / "p.pt")
    p2 = PolicyProposer(p1.config, p1.bounds, seed=9, device="cpu")
    p2.load_state_dict(torch.load(tmp_path / "p.pt"))
    obs = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_array_equal(p1.act(obs), p2.act(obs))
    a, b = p1.state_dict(), p2.state_dict()
    assert a["adam"]["step"] == b["adam"]["step"] == 6
    for x, y in zip(a["adam"]["exp_avg_sq"], b["adam"]["exp_avg_sq"]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="shapes"):
        PolicyProposer(ProposerConfig(3, 1, hidden=(8,)), p1.bounds,
                       device="cpu").load_state_dict(a)


def test_legacy_npy_reads_without_optax(tmp_path):
    jp, _ = pair(seed=2)
    jp.train(expert_pairs(128), epochs=1, batch_size=64)
    path = tmp_path / "proposer.npy"
    np.save(path, np.asarray([jp.state_dict()], dtype=object), allow_pickle=True)
    state = load_legacy_npy(str(path))
    assert "optax" not in type(state["opt_state"][0]).__module__  # the stand-in
    tp = proposer_from_numpy(state, ProposerConfig(3, 1, hidden=(16, 16)),
                             Bounds.of(-2.0, 2.0, dim=1), device="cpu")
    obs = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    close(tp.act(obs), jp.act(obs), 1e-6)
    assert tp.state_dict()["adam"]["step"] == 2


# --- the policy's proposer= ----------------------------------------------------------------

SEEDED = {
    "CEM": dict(population=32, num_elite=8, max_iterations=2),
    "CMA-ES": dict(population=16, num_elite=4, max_iterations=2),
    "PI2": dict(population=32, max_iterations=2),
    "SPSA": dict(population=8, max_iterations=2),
    "Gradient": dict(population=4, max_iterations=2),
    "CEM-GD": dict(population=32, num_elite=8, max_iterations=2, gd_candidates=2,
                   gd_iterations=2),
    "fused CEM": dict(population=32, num_elite=8, max_iterations=2, rollout_backend="fused"),
}


def learned_handler(hidden=(16,)):
    return DynamicsHandler(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=hidden,
                                                 ensemble_size=2), device="cpu")


@pytest.mark.parametrize("label", sorted(SEEDED))
def test_proposer_seeds_the_solver(label):
    handler = learned_handler()
    proposer = PolicyProposer(ProposerConfig(3, 1, hidden=(8,)), Bounds.of(-2.0, 2.0, dim=1),
                              seed=1, device="cpu")
    policy = MPCPolicy(BoxSpace.of(-2.0, 2.0, dim=1), pendulum_reward, handler,
                       solver_name=label.removeprefix("fused "), num_agents=2,
                       planning_horizon=5, proposer=proposer, device="cpu", **SEEDED[label])
    seen = []
    solve = policy._solver.solve

    def capture(state, *args):
        seen.append(state)
        return solve(state, *args)

    policy._solver = policy._solver._replace(solve=capture)
    obs = np.asarray([[-1.0, 0.0, 0.0], [0.3, 0.9, -0.5]], np.float32)
    action, _, _ = policy.act(obs)
    assert np.isfinite(action).all()
    field = policy._solver.plan_field
    proposal = make_plan_proposal_fn(proposer.config, proposer.bounds, handler.mean_dynamics_fn,
                                     5)(proposer.params, handler.dynamics_params,
                                        torch.as_tensor(obs))
    seeded = getattr(seen[0], field)
    np.testing.assert_array_equal(seeded.numpy(), proposal.reshape(seeded.shape).numpy())


@pytest.mark.parametrize("name", ["RandomSearch", "PSO"])
def test_proposer_refuses_planless_solvers(name):
    proposer = PolicyProposer(ProposerConfig(3, 1, hidden=(8,)), Bounds.of(-2.0, 2.0, dim=1),
                              device="cpu")
    with pytest.raises(ValueError, match="plan-carrying"):
        MPCPolicy(BoxSpace.of(-2.0, 2.0, dim=1), pendulum_reward, learned_handler(),
                  solver_name=name, planning_horizon=5, population=16, proposer=proposer,
                  device="cpu")


def test_switch_solver_derives_the_plan_field_again():
    proposer = PolicyProposer(ProposerConfig(3, 1, hidden=(8,)), Bounds.of(-2.0, 2.0, dim=1),
                              device="cpu")
    policy = MPCPolicy(BoxSpace.of(-2.0, 2.0, dim=1), pendulum_reward,
                       DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                       solver_name="CEM", planning_horizon=8, population=32, num_elite=8,
                       max_iterations=2, proposer=proposer, device="cpu")
    assert policy._proposer_field == "mean"
    policy.switch_solver("SPSA")
    assert policy._proposer_field == "solution" and policy.solver_name == "SPSA"
    assert np.isfinite(policy.act(np.asarray([-1.0, 0.0, 0.0], np.float32))[0]).all()
    with pytest.raises(ValueError, match="plan-carrying"):
        policy.switch_solver("PSO")
    assert policy.solver_name == "SPSA" and policy._proposer_field == "solution"


# --- the committed checkpoint --------------------------------------------------------------


@pytest.fixture(scope="module")
def committed():
    """JAX's handler and proposer of ckpt_gradient_bc_300 and the port's conversions."""
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(str(CKPT / "proposer"))
    hidden = tuple(int(layer["w"].shape[1]) for layer in raw["params"][:-1])
    dim_s, dim_u = raw["params"][0]["w"].shape[0], raw["params"][-1]["w"].shape[1]
    jbounds = JBounds.of(-1.0, 1.0, dim=dim_u)  # HalfCheetah's action space
    jp = jprop.PolicyProposer(jprop.ProposerConfig(dim_s=dim_s, dim_u=dim_u, hidden=hidden),
                              jbounds)
    template = jp.state_dict()
    restore_args = jax.tree_util.tree_map(
        lambda _: ocp.RestoreArgs(restore_type=np.ndarray), template)
    jp.load_state_dict(ocp.PyTreeCheckpointer().restore(str(CKPT / "proposer"), item=template,
                                                        restore_args=restore_args))
    jh = JHandler.load(str(CKPT / "handler"), learning_rate=LEARNING_RATE)
    ts = jh._train_state
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    th = handler_from_numpy(
        meta=json.loads((CKPT / "handler" / "config.json").read_text()),
        params=to_np(ts.params), opt_state=to_np(ts.opt_state), step=np.asarray(ts.step),
        stats={f: np.asarray(getattr(jh.dynamics_params.stats, f)) for f in STATS_FIELDS},
        replay=jh.replay.state_dict(), device="cpu", learning_rate=LEARNING_RATE)
    tp = proposer_from_numpy(jp.state_dict(), ProposerConfig(dim_s=dim_s, dim_u=dim_u,
                                                             hidden=hidden),
                             Bounds.of(-1.0, 1.0, dim=dim_u), device="cpu")
    return jh, jp, th, tp


def cheetah_reward(xp):
    def reward(s, a, ns):  # benchmarks/cheetah_mbrl.py:90-93
        return (ns[:, 0] - s[:, 0]) / 0.05 - 0.1 * xp.sum(xp.square(a), -1)
    return reward


def test_committed_proposer_crosses_over(committed):
    jh, jp, th, tp = committed
    assert tp.config.hidden == (64, 64) and tp.state_dict()["adam"]["step"] > 0
    states = jh.replay.arrays()[0][:64]
    close(tp.act(states), jp.act(states), STEP_TOL)
    # The H=15 proposal, each step from JAX's own state (1e-5), and free running.
    obs = states[:8]
    japply = jprop.make_proposer_apply(jp.config, jp.bounds)
    tapply = make_proposer_apply(tp.config, tp.bounds)
    s = jnp.asarray(obs)
    for _ in range(15):
        a = japply(jp.params, s)
        close(tapply(tp.params, torch.as_tensor(np.array(s))), a, STEP_TOL)
        nxt = jh.mean_dynamics_fn(jh.dynamics_params, s, a)
        got = th.mean_dynamics_fn(th.dynamics_params, torch.as_tensor(np.array(s)),
                                  torch.as_tensor(np.array(a)))
        close(got / max(1.0, float(jnp.abs(nxt).max())), nxt / max(1.0, float(jnp.abs(nxt).max())),
              STEP_TOL)
        s = nxt
    want = jprop.make_plan_proposal_fn(jp.config, jp.bounds, jh.mean_dynamics_fn, 15)(
        jp.params, jh.dynamics_params, jnp.asarray(obs))
    got = make_plan_proposal_fn(tp.config, tp.bounds, th.mean_dynamics_fn, 15)(
        tp.params, th.dynamics_params, torch.as_tensor(obs))
    close(got, want, FREE_RUNNING_TOL)


def test_committed_proposer_seeds_a_gradient_plan(committed, monkeypatch):
    """The port's Gradient solve seeded by the committed proposer (32 restarts, 20 Adam
    steps, H=15, two agents) on JAX's restarts and proposal: the restarts equal JAX's; at every
    plan the port's polish visits, JAX's gradient of the return and the port's agree
    (GRAD_TOL), and so do optax's Adam update and the port's from the same gradients
    (ADAM_TOL); the final argmax picks the plan JAX's rewards pick (1e-5).

    A whole step is not held at 1e-4: Adam divides each gradient by its own running scale, so
    an element whose gradient is small beside the terms summed into it turns their float32
    rounding into a relative error of its update (measured 2.8e-4 on 3 of 5760 elements)."""
    jh, jp, th, tp = committed
    restarts, horizon, agents, steps, lr = 32, 15, 2, 20, 0.1
    tpol = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=6), cheetah_reward(torch), th, proposer=tp,
                     solver_name="Gradient", num_agents=agents, planning_horizon=horizon,
                     population=restarts, max_iterations=steps, learning_rate=lr,
                     device="cpu")
    obs = jh.replay.arrays()[0][100:102]
    proposal = jprop.make_plan_proposal_fn(jp.config, jp.bounds, jh.mean_dynamics_fn, horizon)(
        jp.params, jh.dynamics_params, jnp.asarray(obs))
    tpol._propose = lambda *args: torch.as_tensor(np.array(proposal))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7), (restarts, agents, horizon, 6)))
    monkeypatch.setattr(tgrad, "restart_noise", lambda g, shape, device: torch.as_tensor(noise))
    points = []
    polish = tbase.adam_polish

    def recording(evaluate, *args):
        def record(p):
            points.append(p.detach().clone())
            return evaluate(p)
        out = polish(record, *args)
        points.append(out)
        return out

    monkeypatch.setattr(tbase, "adam_polish", recording)
    tplan, treward = tpol.plan(obs)
    # The restarts, as JAX's Gradient solver makes them from the seeded plan.
    std = np.sqrt(np.asarray(jbase.init_solution_variance(JBounds.of(-1.0, 1.0, dim=6), horizon,
                                                          agents)))
    restarts0 = np.clip(np.concatenate([np.asarray(proposal)[None],
                                        np.asarray(proposal) + std * noise[1:]]), -1.0, 1.0)
    close(points[0], restarts0, 1e-6)
    jev = j_evaluator(lambda s, a: jh.dynamics_fn(jh.dynamics_params, s, a), cheetah_reward(jnp))
    tev = make_trajectory_evaluator(lambda s, a: th.dynamics_fn(th.dynamics_params, s, a),
                                    cheetah_reward(torch), device="cpu")
    jobs, tobs = jnp.asarray(obs), torch.as_tensor(obs)
    grad = jax.jit(jax.grad(lambda p: -jnp.mean(jev(jobs, p))))
    opt = optax.adam(lr)
    opt_state = opt.init(jnp.asarray(points[0]))
    adam = tbase.AdamState.zeros_like([points[0]])
    for k in range(steps):
        here = jnp.asarray(points[k].numpy())
        want = np.array(grad(here))
        leaf = points[k].clone().requires_grad_(True)
        (got,) = torch.autograd.grad(-tev(tobs, leaf).mean(), leaf)
        close(got / np.abs(want).max(), want / np.abs(want).max(), GRAD_TOL)
        # Adam, fed the same gradients: optax's update and the port's.
        updates, opt_state = opt.update(jnp.asarray(want), opt_state, here)
        adam, (update,) = tbase.adam_update(adam, [torch.as_tensor(want)], lr)
        close(update, updates, ADAM_TOL)
    final = jnp.asarray(points[-1].numpy())
    rewards = np.asarray(jev(jobs, final))
    best = np.argmax(rewards, axis=0)
    close(tplan, np.asarray(final)[best, np.arange(agents)], STEP_TOL)
    close(treward, rewards.max(axis=0) / 1.0, STEP_TOL * max(1.0, np.abs(rewards).max()))
