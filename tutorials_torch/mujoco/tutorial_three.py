"""Tutorial: bring your own MuJoCo env and planning cost.

Torch twin of ``tutorials/mujoco/tutorial_three.py``: a user-defined HalfCheetah subclass with
a custom observation layout (``env_modified.HalfCheetahEnvModified``) and a hand-written
planning cost (``cost_func.reward_function``), wired through ``make_custom_vec_env`` and the
iterative MBRL loop. Requires gymnasium[mujoco].
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Custom MuJoCo env + custom cost", refinements=1, steps=50, num_envs=2)

import numpy as np

from blackbox_mpc_torch import (LearnedDynamicsConfig, learn_dynamics_iteratively_w_mpc,
                                perform_rollouts)
from blackbox_mpc_torch.envs import make_custom_vec_env

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from cost_func import reward_function
from env_modified import HalfCheetahEnvModified

env = make_custom_vec_env(
    HalfCheetahEnvModified, num_envs=args.num_envs, mode="subprocess", base_seed=args.seed
)
handler, policy = learn_dynamics_iteratively_w_mpc(
    env,
    reward_function,
    solver_name="CEM",
    planning_horizon=15,
    number_of_initial_rollouts=2,
    number_of_rollouts_per_refinement=1,
    number_of_refinement_steps=args.refinements,
    rollout_horizon=args.steps,
    dynamics_config=LearnedDynamicsConfig(
        dim_s=HalfCheetahEnvModified.OBS_DIM, dim_u=6, hidden=(200, 200)
    ),
    epochs=15,
    batch_size=256,
    population=500,
    num_elite=50,
    max_iterations=3,
    seed=args.seed,
    device=args.device,
)
final = perform_rollouts(env, policy, number_of_rollouts=1, rollout_horizon=args.steps)
env.close()
print(f"custom-env MPC episode reward: {np.mean(final['reward_sum']):.1f}")
