"""Tutorial: control from a previously saved dynamics model (standalone entry point).

Torch twin of ``tutorials/save_load/tutorial_two.py``: a *separate process* that builds an MPC
controller purely from a checkpoint directory, no training code in sight. If the checkpoint
does not exist yet, it is created first (run ``save_load/tutorial_one.py`` or this script
once).
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Load-then-control from a checkpoint", steps=60,
             ckpt="/tmp/bbmpc_torch_saved_model")

import os

from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

if not os.path.exists(os.path.join(args.ckpt, "config.json")):
    print(f"no checkpoint at {args.ckpt}; training one first ...")
    from blackbox_mpc_torch import LearnedDynamicsConfig, RandomPolicy, learn_dynamics_from_policy

    boot_env = NativePendulumVecEnv(num_envs=2, seed=args.seed)
    handler, _, _ = learn_dynamics_from_policy(
        boot_env, RandomPolicy(boot_env.action_space, num_agents=2, seed=args.seed),
        dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
        number_of_rollouts=5, rollout_horizon=60, epochs=30, device=args.device,
    )
    handler.save(args.ckpt)

# The load-then-control path: everything the controller needs (weights, optimizer state,
# normalizer stats, replay) comes back from the checkpoint.
env = NativePendulumVecEnv(num_envs=1, seed=args.seed, max_episode_steps=args.steps)
policy = MPCPolicy(
    action_space=env.action_space,
    reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler.load(args.ckpt, device=args.device),
    solver_name="CEM",
    num_agents=1,
    planning_horizon=20,
    population=256,
    num_elite=25,
    max_iterations=5,
    device=args.device,
)
obs = env.reset()
policy.reset()
total = 0.0
for t in range(args.steps):
    action, expected_obs, expected_reward = policy.act(obs[0], t)
    obs, reward, done, info = env.step(action[None])
    total += float(reward[0])
print(f"episode reward with the restored model: {total:.1f}")
