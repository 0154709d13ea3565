"""Tutorial: POPLIN-style plan proposer: a behaviour-cloned policy net seeds the solver.

Torch twin of ``tutorials/proposer/tutorial_one.py``. The proposer is a small policy network
behaviour-cloned on the MPC's own replay actions; at solve time it is unrolled through the
posterior-mean dynamics and replaces the solver's carried plan, so refinement starts from a
good trajectory instead of a blank one (POPLIN-A lineage, Wang & Ba 2019).

This tutorial runs the whole wiring on pendulum:
 1. iterative MBRL with ``behavior_cloning=True`` (the loop retrains the proposer on the
    replay after every refinement);
 2. the proposer-seeded MPC vs a random policy;
 3. the proposer alone as a distilled reactive policy (``proposer.act``, no planning).
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("POPLIN-style plan proposer on pendulum", refinements=3, steps=80)

import numpy as np

from blackbox_mpc_torch import (LearnedDynamicsConfig, RandomPolicy,
                                learn_dynamics_iteratively_w_mpc, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed, max_episode_steps=args.steps)
handler, policy = learn_dynamics_iteratively_w_mpc(
    env,
    pendulum_reward,
    solver_name="Gradient",          # first-order planner: the pairing where seeding wins most
    planning_horizon=20,
    number_of_initial_rollouts=5,
    number_of_rollouts_per_refinement=1,
    number_of_refinement_steps=args.refinements,
    rollout_horizon=args.steps,
    dynamics_config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64)),
    epochs=25,
    batch_size=128,
    population=16,                   # Gradient: random restarts
    max_iterations=15,               # Adam steps
    behavior_cloning=True,           # train + wire the proposer inside the loop
    bc_epochs=20,
    seed=args.seed,
    device=args.device,
)
assert policy.proposer is not None

mpc = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
rnd = perform_rollouts(env, RandomPolicy(env.action_space, num_agents=2, seed=9),
                       number_of_rollouts=2, rollout_horizon=args.steps)

# The proposer alone is a reactive policy: one tiny MLP forward per step, no planning.
obs = env.reset()
distilled = 0.0
for _ in range(args.steps):
    actions = policy.proposer.act(obs)
    obs, rew, done, info = env.step(actions)
    distilled += float(np.mean(rew))

print(f"proposer-seeded MPC: {np.mean(mpc['reward_sum']):.1f}  vs  random: "
      f"{np.mean(rnd['reward_sum']):.1f}  |  distilled proposer alone: {distilled:.1f}")
