"""Port parity for the workflows: rollouts, ``learn_dynamics_from_policy`` (the whole step,
numpy on both sides: the rollouts and the replay bit for bit, the losses and the weights within
the trainer's tolerances) and ``learn_dynamics_iteratively_w_mpc`` on the CPU (MPC beats
random, resume, refusals), plus the metric tags and the device-side elite mask."""
import json

import jax
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu as jpkg
import blackbox_mpc_torch as tpkg
from blackbox_mpc_tpu.envs import NativePendulumVecEnv as JPendulum
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.workflows.dynamics_learning import rollouts_to_episodes as j_episodes
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.utils.metrics import MetricsWriter
from blackbox_mpc_torch.workflows.dynamics_learning import rollouts_to_episodes

LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4  # as tests/test_torch_learning.py


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_learn_dynamics_from_policy_matches_jax():
    jcfg = JConfig(dim_s=3, dim_u=1, hidden=(32, 32), ensemble_size=5)
    tcfg = tpkg.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(32, 32), ensemble_size=5)
    jh = jpkg.DynamicsHandler(config=jcfg, seed=2, learning_rate=3e-3)
    th = tpkg.DynamicsHandler(tcfg, seed=2, learning_rate=3e-3, device="cpu")
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu"))
    jenv, tenv = JPendulum(num_envs=2, seed=4, max_episode_steps=30), \
        NativePendulumVecEnv(num_envs=2, seed=4, max_episode_steps=30)
    for call in range(2):
        kwargs = dict(number_of_rollouts=2, rollout_horizon=30, epochs=3, batch_size=32)
        jh, jres, jm = jpkg.learn_dynamics_from_policy(
            jenv, jpkg.RandomPolicy(jenv.action_space, num_agents=2, seed=call), handler=jh,
            **kwargs)
        th, tres, tm = tpkg.learn_dynamics_from_policy(
            tenv, tpkg.RandomPolicy(tenv.action_space, num_agents=2, seed=call), handler=th,
            **kwargs)
        for key in ("observations", "actions", "rewards", "dones"):
            for j, t in zip(jres[key], tres[key]):
                np.testing.assert_array_equal(t, j)
        assert tres["reward_sum"] == jres["reward_sum"]
        for k, v in jh.replay.state_dict().items():
            np.testing.assert_array_equal(th.replay.state_dict()[k], v)
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL)
        for t, j in zip(th.dynamics_params.params, jh.dynamics_params.params):
            for k in ("w", "b"):
                np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0,
                                           atol=PARAM_ATOL)


def test_rollouts_to_episodes_truncates_like_jax():
    done = np.zeros((6, 3), bool)
    done[2, 0] = done[4, 1] = True  # env 2 never ends
    result = {"observations": [np.arange(7 * 3 * 2, dtype=np.float32).reshape(7, 3, 2)],
              "actions": [np.arange(6 * 3, dtype=np.float32).reshape(6, 3, 1)],
              "dones": [done]}
    (j_obs, j_acts), (t_obs, t_acts) = j_episodes(result), rollouts_to_episodes(result)
    assert [x.shape for x in t_obs] == [(4, 2), (6, 2), (7, 2)]
    assert [x.shape for x in t_acts] == [(3, 1), (5, 1), (6, 1)]
    for j, t in zip(j_obs + j_acts, t_obs + t_acts):
        np.testing.assert_array_equal(t, j)


def test_perform_rollouts_shapes_and_refusals():
    env = NativePendulumVecEnv(num_envs=2, seed=0, max_episode_steps=30)
    policy = tpkg.RandomPolicy(env.action_space, num_agents=2, seed=0)
    result = tpkg.perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=30)
    assert result.observations[0].shape == (31, 2, 3)
    assert result["actions"][0].shape == (30, 2, 1)
    assert result["rewards"][0].shape == (30, 2) and result["dones"][0].shape == (30, 2)
    assert len(result["reward_sum"]) == 2 and result["latency"]["count"] == 60
    with pytest.raises(ValueError, match="model-based"):
        tpkg.perform_rollouts(env, policy, overlap=True)


def true_policy(env, solver="RandomSearch", **kw):
    handler = tpkg.DynamicsHandler(true_model=pendulum_dynamics, device="cpu")
    return tpkg.MPCPolicy(env.action_space, pendulum_reward, handler, solver_name=solver,
                          num_agents=env.num_envs, planning_horizon=5, population=32,
                          device="cpu", **kw)


def test_rollout_metrics_tag_superset_of_reference():
    """Mirrors tests/test_policy_env_workflows.py: every tag the JAX package writes."""
    env = NativePendulumVecEnv(num_envs=2, seed=0, max_episode_steps=10)
    writer = MetricsWriter()
    policy = true_policy(env, metrics_writer=writer)
    tpkg.perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=10,
                          metrics_writer=writer)
    reference_tags = {
        "rewards/actual_reward",
        "states/predicted_observations_abs_error",
        "rewards/predicted_reward_abs_error",
        "rewards/actual_episode_reward",
        "rewards/predicted_episode_reward",
        "perf/solves_per_s",
        "perf/rollouts_per_s",
        "perf/act_latency_p50_s",
        "rewards/predicted_reward",  # the policy's own, once per act()
    }
    missing = reference_tags - set(writer.history)
    assert not missing, f"reference scalar tags not emitted: {missing}"
    assert "perf/act_latency_p95_s" in writer.history
    assert len(writer.history["states/predicted_observations_abs_error"]) == 20
    assert len(writer.history["rewards/predicted_reward"]) == 20
    assert len(writer.history["rewards/predicted_episode_reward"]) == 2
    errs = [v for _, v in writer.history["states/predicted_observations_abs_error"]]
    assert max(errs) < 1e-4, errs  # the true model on its own env


def test_metrics_writer_files(tmp_path):
    writer = MetricsWriter(log_dir=str(tmp_path), tensorboard=False)
    writer.scalar("a", 1.5, 3)
    writer.close()
    line = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert line == {"tag": "a", "value": 1.5, "step": 3} and writer.latest("a") == 1.5


def test_iterative_mbrl_improves_over_random_and_resumes(tmp_path):
    """Mirrors tests/test_policy_env_workflows.py's MBRL test on the port, on the CPU."""
    env = NativePendulumVecEnv(num_envs=2, seed=1, max_episode_steps=60)
    common = dict(solver_name="CEM", planning_horizon=15, rollout_horizon=60,
                  batch_size=128, population=128, num_elite=16, max_iterations=3, seed=0,
                  checkpoint_dir=str(tmp_path), device="cpu")
    handler, policy = tpkg.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_initial_rollouts=4, number_of_refinement_steps=2,
        dynamics_config=tpkg.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
        epochs=25, **common)
    random_result = tpkg.perform_rollouts(
        env, tpkg.RandomPolicy(env.action_space, num_agents=2, seed=9),
        number_of_rollouts=2, rollout_horizon=60)
    mpc_result = tpkg.perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=60)
    assert np.mean(mpc_result["reward_sum"]) > np.mean(random_result["reward_sum"]), (
        mpc_result["reward_sum"], random_result["reward_sum"])
    assert json.loads((tmp_path / "loop_state.json").read_text()) == {
        "completed_refinements": 2}
    # Resume: the checkpointed handler continues at the next refinement.
    resumed, _ = tpkg.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_refinement_steps=3, epochs=1, resume=True,
        **dict(common, rollout_horizon=5))
    assert json.loads((tmp_path / "loop_state.json").read_text()) == {
        "completed_refinements": 3}
    assert len(resumed.replay) == len(handler.replay) + 10
    assert resumed.train_state.step > handler.train_state.step


def test_iterative_mbrl_refusals(tmp_path):
    env = NativePendulumVecEnv(num_envs=1)
    # overlap and behavior_cloning run (tests/test_torch_pipeline.py); cloning needs a replay.
    with pytest.raises(ValueError, match="learned-dynamics handler"):
        tpkg.learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, device="cpu", number_of_initial_rollouts=0,
            behavior_cloning=True, handler=true_policy(env).dynamics_handler)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tpkg.learn_dynamics_iteratively_w_mpc(env, pendulum_reward, resume=True, device="cpu")
    with pytest.raises(ValueError, match="pre-trained handler"):
        tpkg.learn_dynamics_iteratively_w_mpc(env, pendulum_reward, device="cpu",
                                              number_of_initial_rollouts=0)
    with pytest.raises(ValueError, match="model-based"):
        tpkg.perform_rollouts(env, tpkg.RandomPolicy(env.action_space, num_agents=1),
                              overlap=True)


def test_record_rollout_writes_frames(tmp_path):
    env = NativePendulumVecEnv(num_envs=1, max_episode_steps=4)
    total = tpkg.record_rollout(env, true_policy(env), horizon=4, path=str(tmp_path / "x.gif"))
    assert np.isfinite(total) and list(tmp_path.iterdir())


@pytest.mark.parametrize("weights", [False, True])
def test_scatter_by_rank_same_as_scalar_write(weights, rng):
    """The elite mask written from a device source equals the scalar write it replaced."""
    rewards = torch.as_tensor(rng.normal(size=(40, 3)), dtype=torch.float32)
    order = torch.argsort(-rewards.T, dim=1, stable=True)
    idx = order if weights else order[:, :7]
    values = torch.as_tensor(rng.uniform(size=40), dtype=torch.float32) if weights else None
    want = torch.zeros((40, 3))
    want[idx.T, torch.arange(3)[None, :]] = values[:, None] if weights else 1.0
    assert torch.equal(fc._scatter_by_rank(values, idx, 40), want)
