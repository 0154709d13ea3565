"""Tutorial: iterative model-based RL on pendulum.

Torch twin of ``tutorials/model_based_rl/tutorial_one.py``: bootstrap a learned model from
random rollouts, then alternate MPC data collection and retraining
(``learn_dynamics_iteratively_w_mpc``), and compare the final MPC controller with a random
policy.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Iterative MBRL on pendulum", refinements=3, steps=80)

import numpy as np

from blackbox_mpc_torch import (LearnedDynamicsConfig, RandomPolicy,
                                learn_dynamics_iteratively_w_mpc, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed, max_episode_steps=args.steps)
handler, policy = learn_dynamics_iteratively_w_mpc(
    env,
    pendulum_reward,
    solver_name="CEM",
    planning_horizon=20,
    number_of_initial_rollouts=5,
    number_of_rollouts_per_refinement=1,
    number_of_refinement_steps=args.refinements,
    rollout_horizon=args.steps,
    dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
    epochs=25,
    batch_size=128,
    population=256,
    num_elite=25,
    max_iterations=5,
    seed=args.seed,
    device=args.device,
)
mpc = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
rnd = perform_rollouts(env, RandomPolicy(env.action_space, num_agents=2, seed=9),
                       number_of_rollouts=2, rollout_horizon=args.steps)
print(f"learned-model MPC: {np.mean(mpc['reward_sum']):.1f}  vs  "
      f"random: {np.mean(rnd['reward_sum']):.1f}")
