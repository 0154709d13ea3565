"""Tutorial: checkpoint a trained dynamics model and restore it for control.

Torch twin of ``tutorials/save_load/tutorial_one.py``: train, ``handler.save(dir)``, then
``DynamicsHandler.load(dir)`` and control with the restored model.
"""
import sys, pathlib, tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Checkpoint save/load", steps=60)

from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MPCPolicy,
                                RandomPolicy, learn_dynamics_from_policy, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed)
handler, _, metrics = learn_dynamics_from_policy(
    env, RandomPolicy(env.action_space, num_agents=2, seed=args.seed),
    dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
    number_of_rollouts=5, rollout_horizon=args.steps, epochs=30, device=args.device,
)
ckpt = tempfile.mkdtemp(prefix="bbmpc_ckpt_")
handler.save(ckpt)
print(f"saved to {ckpt} (val loss {metrics['val_loss']:.5f})")

restored = DynamicsHandler.load(ckpt, device=args.device)
policy = MPCPolicy(
    action_space=env.action_space, reward_function=pendulum_reward,
    dynamics_handler=restored, solver_name="CEM", num_agents=2,
    planning_horizon=20, population=256, num_elite=25, max_iterations=5, device=args.device,
)
result = perform_rollouts(env, policy, number_of_rollouts=1, rollout_horizon=args.steps)
print(f"restored-model MPC episode reward: {result['reward_sum'][0]:.1f}")
