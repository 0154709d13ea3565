"""Port parity for the environments: the port's native pendulum and cart-pole against the JAX
package's (the same seed and actions give the same bits), the shared-memory vec env against
the port's pipe backend (mirroring tests/test_shm_env.py), and the gym-style vec env's
backends."""
import os

import numpy as np
import pytest

import blackbox_mpc_tpu.envs as jenvs
import blackbox_mpc_torch.envs as tenvs
from blackbox_mpc_torch.envs import shm_vec_env


def _bits(x):
    x = np.asarray(x)
    return x.dtype.str, x.shape, x.tobytes()


@pytest.mark.parametrize("name", ["NativePendulumVecEnv", "NativeCartpoleVecEnv"])
def test_native_env_bit_for_bit_with_jax(name):
    jenv = getattr(jenvs, name)(num_envs=3, seed=5, max_episode_steps=12)
    tenv = getattr(tenvs, name)(num_envs=3, seed=5, max_episode_steps=12)
    np.testing.assert_array_equal(tenv.action_space.low, jenv.action_space.low)
    np.testing.assert_array_equal(tenv.observation_space.high, jenv.observation_space.high)
    rng = np.random.default_rng(0)
    for reset in ("reset", "reset_down", "reseed"):
        if reset == "reseed":
            first = (jenv.reset(seed=11), tenv.reset(seed=11))
        else:
            first = (getattr(jenv, reset)(), getattr(tenv, reset)())
        assert _bits(first[0]) == _bits(first[1])
        for t in range(12):
            a = rng.uniform(-2.5, 2.5, (3, 1)).astype(np.float32)  # some out of bounds
            if t % 2:
                jout = jenv.step(a)
                tenv.step_async(a)
                tout = tenv.step_wait()
            else:
                jout, tout = jenv.step(a), tenv.step(a)
            for j, p in zip(jout[:3], tout[:3]):
                assert _bits(j) == _bits(p)
        assert tout[2].all()  # the episode ends at max_episode_steps
    assert _bits(jenv.render()) == _bits(tenv.render())
    with pytest.raises(RuntimeError, match="without step_async"):
        tenv.step_wait()


def test_shm_library_loads_from_the_repository_root():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert shm_vec_env._lib_path() == os.path.join(root, "native", "libshm_sync.so")
    shm_vec_env._load_lib()  # builds it with make -C native where it is missing


@pytest.fixture(scope="module")
def envs():
    shm = tenvs.make_shm_vec_env("Pendulum-v1", num_envs=3, base_seed=7)
    sub = tenvs.make_gym_vec_env("Pendulum-v1", num_envs=3, mode="subprocess", base_seed=7)
    yield shm, sub
    shm.close()
    sub.close()


def test_shm_matches_pipe_backend(envs):
    shm, sub = envs
    np.testing.assert_allclose(shm.reset(), sub.reset(), atol=1e-6)
    rng = np.random.default_rng(0)
    for _ in range(10):
        a = rng.uniform(-2, 2, (3, 1)).astype(np.float32)
        obs1, rew1, done1, _ = shm.step(a)
        obs2, rew2, done2, _ = sub.step(a)
        np.testing.assert_allclose(obs1, obs2, atol=1e-5)
        np.testing.assert_allclose(rew1, rew2, atol=1e-5)
        np.testing.assert_array_equal(done1, done2)


def test_shm_async_guards(envs):
    shm, _ = envs
    shm.reset()
    with pytest.raises(RuntimeError, match="without step_async"):
        shm.step_wait()
    shm.step_async(np.zeros((3, 1), np.float32))
    with pytest.raises(RuntimeError, match="already pending"):
        shm.step_async(np.zeros((3, 1), np.float32))
    with pytest.raises(RuntimeError, match="step pending"):
        shm.reset()
    shm.step_wait()


class _Broken:
    def __init__(self):
        from blackbox_mpc_torch.core.spaces import BoxSpace

        self.action_space = BoxSpace.of(-1, 1, dim=1)
        self.observation_space = BoxSpace.of(-1, 1, dim=2)

    def reset(self, seed=None):
        return np.zeros(2, np.float32), {}

    def step(self, a):
        raise RuntimeError("boom")

    def close(self):
        pass


def test_shm_worker_error_raises():
    env = tenvs.ShmVecEnv([_Broken] * 2, dim_s=2, dim_u=1, step_timeout_s=10)
    env.reset()
    env.step_async(np.zeros((2, 1), np.float32))
    with pytest.raises(RuntimeError, match="worker .* error"):
        env.step_wait()
    env.close()
    with pytest.raises(RuntimeError, match="closed"):
        env.reset()


def test_shm_works_with_perform_rollouts():
    from blackbox_mpc_torch import RandomPolicy, perform_rollouts

    env = tenvs.make_shm_vec_env("Pendulum-v1", num_envs=2, base_seed=0)
    try:
        result = perform_rollouts(env, RandomPolicy(env.action_space, num_agents=2, seed=0),
                                  number_of_rollouts=1, rollout_horizon=15)
        assert result["observations"][0].shape == (16, 2, 3)
    finally:
        env.close()


@pytest.mark.parametrize("mode", ["sync", "thread"])
def test_gym_vec_env_matches_jax(mode):
    jenv = jenvs.make_gym_vec_env("Pendulum-v1", num_envs=2, mode=mode, base_seed=3)
    tenv = tenvs.make_gym_vec_env("Pendulum-v1", num_envs=2, mode=mode, base_seed=3)
    try:
        assert _bits(jenv.reset()) == _bits(tenv.reset())
        rng = np.random.default_rng(1)
        for _ in range(5):
            a = rng.uniform(-2, 2, (2, 1)).astype(np.float32)
            for j, p in zip(jenv.step(a)[:3], tenv.step(a)[:3]):
                assert _bits(j) == _bits(p)
    finally:
        jenv.close()
        tenv.close()


def test_custom_vec_env_and_errors():
    env = tenvs.make_custom_vec_env(lambda: _GymPendulum(), num_envs=2)
    assert env.reset().shape == (2, 3)
    assert env.step(np.zeros((2, 1), np.float32))[0].shape == (2, 3)
    env.close()
    with pytest.raises(ValueError, match="mode"):
        tenvs.GymVecEnv([_GymPendulum], mode="bogus")


class _GymPendulum:
    """The native pendulum behind gymnasium's single-env API."""

    def __init__(self):
        self._env = tenvs.NativePendulumVecEnv(num_envs=1)
        self.action_space = self._env.action_space
        self.observation_space = self._env.observation_space

    def reset(self, seed=None):
        return self._env.reset(seed)[0], {}

    def step(self, action):
        obs, reward, done, _ = self._env.step(np.asarray(action).reshape(1, -1))
        return obs[0], float(reward[0]), bool(done[0]), False, {}

    def close(self):
        pass
