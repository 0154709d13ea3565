"""Tutorial: iterative MBRL on MuJoCo HalfCheetah (collect-with-MPC + retrain).

Torch twin of ``tutorials/mujoco/tutorial_two.py``. Scaled-down defaults so it runs in minutes;
raise --refinements/--steps for the full experience. Requires gymnasium[mujoco].
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Iterative MBRL on HalfCheetah", refinements=2, steps=100, num_envs=2)

import torch

from blackbox_mpc_torch import LearnedDynamicsConfig, learn_dynamics_iteratively_w_mpc
from blackbox_mpc_torch.envs import make_gym_vec_env


def cheetah_reward(state, action, next_state):
    return (next_state[:, 0] - state[:, 0]) / 0.05 - 0.1 * torch.sum(
        torch.square(action), dim=-1
    )


env = make_gym_vec_env(
    "HalfCheetah-v5", num_envs=args.num_envs, mode="subprocess", base_seed=args.seed,
    exclude_current_positions_from_observation=False,
)
handler, policy = learn_dynamics_iteratively_w_mpc(
    env,
    cheetah_reward,
    solver_name="CEM",
    planning_horizon=15,
    number_of_initial_rollouts=3,
    number_of_rollouts_per_refinement=1,
    number_of_refinement_steps=args.refinements,
    rollout_horizon=args.steps,
    dynamics_config=LearnedDynamicsConfig(
        dim_s=env.observation_space.dim, dim_u=env.action_space.dim, hidden=(500, 500, 500)
    ),
    epochs=15,
    batch_size=256,
    population=512,
    num_elite=50,
    max_iterations=5,
    seed=args.seed,
    device=args.device,
)
env.close()
print("done; handler replay size:", len(handler.replay))
