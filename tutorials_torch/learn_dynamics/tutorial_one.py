"""Tutorial: learn a dynamics model from random-policy rollouts.

Torch twin of ``tutorials/learn_dynamics/tutorial_one.py``: ``learn_dynamics_from_policy``
with a ``RandomPolicy``, then inspect validation loss and one-step prediction error.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Learn pendulum dynamics from random rollouts", rollouts=5, steps=60)

import numpy as np

from blackbox_mpc_torch import LearnedDynamicsConfig, RandomPolicy, learn_dynamics_from_policy
from blackbox_mpc_torch.envs import NativePendulumVecEnv

env = NativePendulumVecEnv(num_envs=2, seed=args.seed)
policy = RandomPolicy(env.action_space, num_agents=2, seed=args.seed)
handler, rollouts, metrics = learn_dynamics_from_policy(
    env,
    policy,
    dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
    number_of_rollouts=args.rollouts,
    rollout_horizon=args.steps,
    epochs=30,
    batch_size=128,
    device=args.device,
)
print(f"replay size {metrics['replay_size']}, val loss {metrics['val_loss']:.5f}")
obs = env.reset()
actions = policy.act(obs)
pred = handler.predict(obs, actions).cpu().numpy()
nxt, _, _, _ = env.step(actions)
print("one-step prediction error:", float(np.abs(pred - nxt).mean()))
