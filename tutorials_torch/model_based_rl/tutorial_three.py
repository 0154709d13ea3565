"""Tutorial: staged model-based RL: learn from random data, control, learn from MPC data.

Torch twin of ``tutorials/model_based_rl/tutorial_three.py``: instead of the one-call
iterative loop, compose the stages yourself: (1) train a dynamics model on random-policy
rollouts, (2) control with MPC on the learned model, (3) collect *with the MPC policy* and
retrain, (4) control again, and watch the episode reward improve as the model sees
on-policy states.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Staged MBRL: random-learn -> control -> MPC-learn -> control", steps=80)

import numpy as np

from blackbox_mpc_torch import (LearnedDynamicsConfig, MPCPolicy, RandomPolicy,
                                learn_dynamics_from_policy, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed, max_episode_steps=args.steps)

# (1) bootstrap the model from random exploration
handler, _, metrics = learn_dynamics_from_policy(
    env, RandomPolicy(env.action_space, num_agents=2, seed=args.seed),
    dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
    number_of_rollouts=5, rollout_horizon=args.steps, epochs=25, device=args.device,
)
print(f"stage 1: trained on random rollouts (val loss {metrics['val_loss']:.5f})")

# (2) control with MPC on the learned model
policy = MPCPolicy(
    action_space=env.action_space, reward_function=pendulum_reward,
    dynamics_handler=handler, solver_name="CEM", num_agents=2,
    planning_horizon=20, population=256, num_elite=25, max_iterations=5, seed=args.seed,
    device=args.device,
)
before = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
print(f"stage 2: MPC on random-data model, mean reward {np.mean(before['reward_sum']):.1f}")

# (3) collect WITH the MPC policy (on-policy states) and retrain the same handler
_, _, metrics = learn_dynamics_from_policy(
    env, policy, handler=handler,
    number_of_rollouts=2, rollout_horizon=args.steps, epochs=25,
)
print(f"stage 3: retrained on MPC rollouts (val loss {metrics['val_loss']:.5f})")

# (4) control again: the policy reads the handler's fresh params at every solve
after = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
print(f"stage 4: MPC on refined model, mean reward {np.mean(after['reward_sum']):.1f} "
      f"(was {np.mean(before['reward_sum']):.1f})")
