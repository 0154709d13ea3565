"""Tutorial: pessimistic planning (ensemble-disagreement penalty) + actuation-rate cost.

Torch twin of ``tutorials/probabilistic/tutorial_two.py``. Two planning-cost knobs layered on
the learned-ensemble stack:

1. ``plan_uncertainty_penalty`` (MOPO-style pessimism): every rollout step subtracts
   ``lambda * mean_S(std_E(member mean-heads))`` from the step reward, so the solver avoids
   regions where the ensemble members disagree (where the model is guessing). Purely a
   planning-time change: training, replay and the trained weights are untouched.
2. ``action_smoothness_weight``: an actuation-rate cost ``w * sum ||a_t - a_{t-1}||^2`` on
   every candidate plan, applied at selection time.

Both compose with any solver; this script trains one small-data ensemble, then compares
plain / pessimistic / pessimistic+smooth planning on the same weights.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Pessimistic + smooth planning on a learned ensemble", steps=80, members=3)

import dataclasses

import numpy as np

from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MPCPolicy,
                                RandomPolicy, learn_dynamics_from_policy, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed, max_episode_steps=args.steps)
cfg = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64), ensemble_size=args.members)
# Deliberately little data: disagreement between members is what pessimism keys on.
handler, _, metrics = learn_dynamics_from_policy(
    env, RandomPolicy(env.action_space, num_agents=2, seed=args.seed),
    dynamics_config=cfg, number_of_rollouts=4, rollout_horizon=args.steps,
    epochs=40, learning_rate=3e-3, device=args.device,
)
print(f"{args.members}-member ensemble on 4 random rollouts, val loss {metrics['val_loss']:.4f}")


def control(lam: float, smooth: float) -> tuple[float, float]:
    # Same trained weights; only the planning objective changes.
    h = DynamicsHandler(config=dataclasses.replace(cfg, plan_uncertainty_penalty=lam),
                        device=args.device)
    h.set_params(handler.dynamics_params)
    policy = MPCPolicy(
        action_space=env.action_space, reward_function=pendulum_reward,
        dynamics_handler=h, solver_name="CEM", num_agents=2,
        planning_horizon=20, population=240, num_elite=24, max_iterations=5,
        seed=args.seed, action_smoothness_weight=smooth, device=args.device,
    )
    result = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
    acts = np.concatenate([np.asarray(a) for a in result["actions"]], axis=0)
    rate = float(np.mean(np.abs(np.diff(acts, axis=0))))
    return float(np.mean(result["reward_sum"])), rate


r0, j0 = control(0.0, 0.0)
r1, j1 = control(1.0, 0.0)
r2, j2 = control(1.0, 0.1)
print(f"plain planning:                reward {r0:8.1f}   mean |da| {j0:.3f}")
print(f"pessimistic (lambda=1):        reward {r1:8.1f}   mean |da| {j1:.3f}")
print(f"pessimistic + smooth (w=0.1):  reward {r2:8.1f}   mean |da| {j2:.3f}")
