"""Tutorial: MPC on MuJoCo HalfCheetah with learned dynamics (random-policy bootstrap).

Torch twin of ``tutorials/mujoco/tutorial_one.py``: collect random rollouts on HalfCheetah,
fit an MLP dynamics model, then run MPC with a hand-written reward on the model state.
Requires gymnasium[mujoco].
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("HalfCheetah MPC with learned dynamics", rollouts=3, steps=100, num_envs=2)

import torch

from blackbox_mpc_torch import (LearnedDynamicsConfig, MPCPolicy, RandomPolicy,
                                learn_dynamics_from_policy, perform_rollouts)
from blackbox_mpc_torch.envs import make_gym_vec_env


def cheetah_reward(state, action, next_state):
    # HalfCheetah-v5 with exclude_current_positions_from_observation=False: obs[0] is x,
    # so forward progress per step approximates the env's forward_reward.
    return (next_state[:, 0] - state[:, 0]) / 0.05 - 0.1 * torch.sum(
        torch.square(action), dim=-1
    )


env = make_gym_vec_env(
    "HalfCheetah-v5", num_envs=args.num_envs, mode="subprocess", base_seed=args.seed,
    exclude_current_positions_from_observation=False,
)
dim_s = env.observation_space.dim
dim_u = env.action_space.dim
print(f"HalfCheetah: dim_s={dim_s} dim_u={dim_u}")

handler, _, metrics = learn_dynamics_from_policy(
    env,
    RandomPolicy(env.action_space, num_agents=args.num_envs, seed=args.seed),
    dynamics_config=LearnedDynamicsConfig(dim_s=dim_s, dim_u=dim_u, hidden=(500, 500, 500)),
    number_of_rollouts=args.rollouts,
    rollout_horizon=args.steps,
    epochs=20,
    batch_size=256,
    device=args.device,
)
print(f"dynamics val loss: {metrics['val_loss']:.5f}")

policy = MPCPolicy(
    action_space=env.action_space,
    reward_function=cheetah_reward,
    dynamics_handler=handler,
    solver_name="CEM",
    num_agents=args.num_envs,
    planning_horizon=15,
    population=512,
    num_elite=50,
    max_iterations=5,
    seed=args.seed,
    device=args.device,
)
result = perform_rollouts(env, policy, number_of_rollouts=1, rollout_horizon=args.steps)
env.close()
print(f"MPC episode reward (env-reported): {result['reward_sum'][0]:.1f}; "
      f"act p50 {result['latency']['p50_s']*1e3:.1f} ms")
