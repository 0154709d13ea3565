from blackbox_mpc_torch.envs.native_cartpole import NativeCartpoleVecEnv
from blackbox_mpc_torch.envs.native_pendulum import NativePendulumVecEnv
from blackbox_mpc_torch.envs.shm_vec_env import ShmVecEnv, make_shm_vec_env
from blackbox_mpc_torch.envs.vec_env import GymVecEnv, make_custom_vec_env, make_gym_vec_env

__all__ = [
    "NativeCartpoleVecEnv",
    "NativePendulumVecEnv",
    "GymVecEnv",
    "make_gym_vec_env",
    "make_custom_vec_env",
    "ShmVecEnv",
    "make_shm_vec_env",
]
