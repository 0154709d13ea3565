"""The port's speculative pipeline (``policies/pipeline.py``, ``perform_rollouts(overlap=True)``)
and the MBRL loop's ``behavior_cloning``/``overlap``, as ``tests/test_pipeline.py`` and
``tests/test_proposer.py`` hold the JAX package's.

A miss solves again with the step's own generators, so a pipeline that never adopts a
speculation (``spec_tol=None``, or a miss at every step) gives the bits of the synchronous
per-step-seeded run; those are compared with ``np.testing.assert_array_equal``.
"""
import os

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MetricsWriter, MPCPolicy,
                                learn_dynamics_iteratively_w_mpc, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.learning.orbax_read import leaf_digests, restore_pytree
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import proposer_to_numpy
from blackbox_mpc_torch.policies import RandomPolicy
from blackbox_mpc_torch.policies.pipeline import SpeculativePipeline


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def true_policy(num_agents=2, seed=0, **kw):
    return MPCPolicy(NativePendulumVecEnv().action_space, pendulum_reward,
                     DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                     solver_name="CEM", num_agents=num_agents, planning_horizon=25,
                     population=256, num_elite=25, max_iterations=5, seed=seed, device="cpu",
                     **kw)


def learned_policy(seed=0, **kw):
    handler = DynamicsHandler(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16),
                                                    ensemble_size=2), seed=1, device="cpu")
    return MPCPolicy(NativePendulumVecEnv().action_space, pendulum_reward, handler,
                     solver_name="CEM", num_agents=2, planning_horizon=10, population=64,
                     num_elite=8, max_iterations=3, seed=seed, device="cpu", **kw)


def pipelined(policy, tol, steps, seed=3):
    env = NativePendulumVecEnv(num_envs=2, seed=seed)
    pipe = SpeculativePipeline(policy, spec_tol=tol)
    pipe.reset()
    obs, actions, hits = env.reset_down(), [], []
    for t in range(steps):
        action, pred_next, _, hit = pipe.act(obs, t)
        env.step_async(action)
        obs = env.step_wait()[0]
        actions.append(action)
        hits.append(hit)
    return actions, hits, pipe, obs


def synchronous(policy, steps, seed=3):
    """``act()``s in turn, each solving with the pipeline's generators of its step."""
    env = NativePendulumVecEnv(num_envs=2, seed=seed)
    pipe = SpeculativePipeline(policy, spec_tol=None)
    pipe.reset()  # draws the episode seed as a pipelined run does
    obs, actions = env.reset_down(), []
    for t in range(steps):
        action, policy._solver_state, _, _, _ = policy._step(
            policy._solver_state, torch.as_tensor(obs), t, *pipe.step_generators(t), False)
        actions.append(action.numpy())
        obs = env.step(actions[-1])[0]
    return actions


def test_speculation_hits_with_a_perfect_model():
    """With the true model the predicted observation is the env's, so every step after the
    first adopts its speculation, and the pendulum still swings up."""
    actions, hits, pipe, obs = pipelined(true_policy(), 1e-3, 80)
    assert not hits[0] and all(hits[1:])
    assert (pipe.hits, pipe.misses) == (79, 0) and pipe.hit_rate == 1.0
    assert np.all(obs[:, 0] > 0.85), obs


@pytest.mark.parametrize("tol", [None, 0.0])
def test_a_miss_is_the_exact_solve_bit_for_bit(tol):
    """``spec_tol=None`` (prefetch only) and ``spec_tol=0`` (a learned model's prediction never
    equals the env: every step a miss) both give the synchronous run's bits."""
    steps = 12
    actions, hits, pipe, _ = pipelined(learned_policy(seed=7), tol, steps)
    exact = synchronous(learned_policy(seed=7), steps)
    for got, want in zip(actions, exact):
        np.testing.assert_array_equal(got, want)
    assert not any(hits)
    assert pipe.misses == (0 if tol is None else steps - 1)


def test_a_hit_adopts_the_speculative_solve():
    """Accepting every speculation acts on the solve from the predicted observation: the
    speculative solve of step t+1 started from the committed state of step t."""
    steps = 6
    actions, hits, _, _ = pipelined(learned_policy(seed=7), float("inf"), steps)
    assert not hits[0] and all(hits[1:])
    policy = learned_policy(seed=7)
    pipe = SpeculativePipeline(policy, spec_tol=None)
    pipe.reset()
    env = NativePendulumVecEnv(num_envs=2, seed=3)
    obs = torch.as_tensor(env.reset_down())
    for t in range(steps):
        action, policy._solver_state, _, obs, _ = policy._step(
            policy._solver_state, obs, t, *pipe.step_generators(t), False)
        np.testing.assert_array_equal(actions[t], action.numpy())


def test_exploration_noise_and_episode_seeds():
    """Noise draws from the step's generator; a new episode draws a new seed."""
    policy = true_policy(seed=1)
    pipe = SpeculativePipeline(policy, spec_tol=None, exploration_noise=True)
    pipe.reset()
    first = pipe._ep_seed
    obs = np.asarray([-1.0, 0.0, 0.0], np.float32)
    a, _, _, _ = pipe.act(obs, 0)
    assert a.shape == (1,) and np.abs(a).max() <= 2.0
    pipe.reset()
    assert pipe._ep_seed != first
    with pytest.raises(ValueError, match="num_agents"):
        pipe.act(np.zeros((3, 3), np.float32), 0)


def test_perform_rollouts_overlap():
    env = NativePendulumVecEnv(num_envs=2, seed=0, max_episode_steps=30)
    writer = MetricsWriter()
    result = perform_rollouts(env, true_policy(), number_of_rollouts=2, rollout_horizon=30,
                              overlap=True, spec_tol=1e-3, metrics_writer=writer)
    assert result["observations"][0].shape == (31, 2, 3)
    assert result["actions"][0].shape == (30, 2, 1)
    assert result["spec_hit_rate"] > 0.9
    assert np.isfinite(result["reward_sum"]).all()
    assert writer.history["perf/spec_hit_rate"][-1][1] == result["spec_hit_rate"]


def test_overlap_refuses_policies_it_cannot_drive():
    env = NativePendulumVecEnv(num_envs=2, seed=0)
    with pytest.raises(ValueError, match="model-based"):
        perform_rollouts(env, RandomPolicy(env.action_space, num_agents=2, seed=0),
                         rollout_horizon=5, overlap=True)
    with pytest.raises(TypeError, match="live MPCPolicy"):
        SpeculativePipeline(object())
    with pytest.raises(RuntimeError, match="reset"):
        SpeculativePipeline(true_policy()).act(np.zeros((2, 3), np.float32), 0)


# --- the loop: behavior_cloning and overlap ------------------------------------------------

LOOP = dict(solver_name="CEM", planning_horizon=8, number_of_initial_rollouts=2,
            number_of_rollouts_per_refinement=1, rollout_horizon=20, epochs=2, batch_size=64,
            behavior_cloning=True, bc_epochs=5, population=32, num_elite=8, max_iterations=2,
            seed=0, device="cpu")


def loop(tmp_path, refinements, **kw):
    env = NativePendulumVecEnv(num_envs=2, seed=0, max_episode_steps=20)
    return learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_refinement_steps=refinements,
        dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16,)),
        checkpoint_dir=str(tmp_path / "loop"), **dict(LOOP, **kw))


def same_state(a: dict, b: dict) -> bool:
    flat = lambda s: ([v for layer in s["params"] for v in layer.values()]  # noqa: E731
                      + s["adam"]["exp_avg"] + s["adam"]["exp_avg_sq"])
    return a["adam"]["step"] == b["adam"]["step"] and all(
        torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def test_loop_with_behaviour_cloning_and_overlap(tmp_path):
    writer = MetricsWriter()
    handler, policy = loop(tmp_path, 3, overlap=True, metrics_writer=writer)
    assert policy.proposer is not None and policy._proposer_field == "mean"
    losses = [v for _, v in writer.history["proposer/bc_loss"]]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses  # the MPC's own actions are learned
    assert len(writer.history["perf/spec_hit_rate"]) == 3
    out = policy.proposer.act(np.zeros((4, 3), np.float32))
    assert out.shape == (4, 1) and np.all(np.abs(out) <= 2.0)
    saved = restore_pytree(tmp_path / "loop" / "proposer")
    assert leaf_digests(saved) == leaf_digests(proposer_to_numpy(policy.proposer))
    assert not (tmp_path / "loop" / "proposer" / "proposer.pt").exists()


def test_loop_resume_restores_the_proposer(tmp_path):
    _, policy = loop(tmp_path, 1)
    _, resumed = loop(tmp_path, 1, resume=True)
    assert same_state(resumed.proposer.state_dict(), policy.proposer.state_dict())


def test_loop_resume_reads_the_legacy_npy(tmp_path):
    """A loop checkpoint of the JAX package from before Orbax keeps the proposer pickled in
    proposer.npy; resume reads it (here the JAX proposer's state, written as JAX wrote it)."""
    import shutil

    from blackbox_mpc_tpu.core.types import Bounds as JBounds
    from blackbox_mpc_tpu.learning.proposer import PolicyProposer as JProposer
    from blackbox_mpc_tpu.learning.proposer import ProposerConfig as JConfig

    loop(tmp_path, 1)
    ckpt = tmp_path / "loop"
    shutil.rmtree(ckpt / "proposer")
    jp = JProposer(JConfig(dim_s=3, dim_u=1), JBounds.of(-2.0, 2.0, dim=1), seed=5)
    np.save(os.path.join(ckpt, "proposer.npy"), np.asarray([jp.state_dict()], dtype=object),
            allow_pickle=True)
    _, resumed = loop(tmp_path, 1, resume=True)
    probe = np.asarray([[0.1, -0.2, 0.3], [1.0, 0.0, -2.0]], np.float32)
    np.testing.assert_allclose(resumed.proposer.act(probe), jp.act(probe), rtol=1e-6, atol=1e-6)


def test_loop_behaviour_cloning_needs_a_replay():
    env = NativePendulumVecEnv(num_envs=1)
    with pytest.raises(ValueError, match="learned-dynamics handler"):
        learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, number_of_initial_rollouts=0, behavior_cloning=True,
            handler=DynamicsHandler(true_model=pendulum_dynamics, device="cpu"), device="cpu")
