"""Tutorial: probabilistic ensembles with PETS trajectory-sampling (TS-inf) planning.

Torch twin of ``tutorials/probabilistic/tutorial_one.py``:

1. train a Gaussian-head (mean, logvar) ensemble by negative log-likelihood, with the PETS
   appendix-A.1 learnable logvar bounds (``learn_logvar_bounds=True``), which sampled
   propagation needs (fixed bounds pin head cells at the variance ceiling and collapse
   planning),
2. check the heads' variance calibration (``E[residual^2]/E[sigma^2]`` on the val split,
   ~1.0 = calibrated), the gate metric for trusting sampled rollouts,
3. plan with ``propagation="ts_inf"``: each candidate trajectory is pinned to one ensemble
   member AND samples the learned aleatoric noise at every rollout step, so the optimizer
   prefers plans that are good under model uncertainty, not just under the posterior mean,
4. compare against mean-propagation planning on the same trained ensemble.

Probabilistic planning runs on the ``"eager"`` backend, as in the JAX package.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Probabilistic ensembles + TS-inf planning", steps=80, members=3)

import dataclasses

import numpy as np

from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MPCPolicy,
                                RandomPolicy, learn_dynamics_from_policy, perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward

env = NativePendulumVecEnv(num_envs=2, seed=args.seed, max_episode_steps=args.steps)
cfg = LearnedDynamicsConfig(
    dim_s=3, dim_u=1, hidden=(64, 64), ensemble_size=args.members,
    probabilistic=True, propagation="ts_inf", learn_logvar_bounds=True,
)
handler, _, metrics = learn_dynamics_from_policy(
    env, RandomPolicy(env.action_space, num_agents=2, seed=args.seed),
    dynamics_config=cfg, number_of_rollouts=8, rollout_horizon=args.steps,
    epochs=60, learning_rate=3e-3, device=args.device,
)
print(f"NLL-trained {args.members}-member ensemble, val loss {metrics['val_loss']:.4f}")
# Gate metric before trusting sampled propagation: ratio far below 1 means oversized
# noise (the fixed-bound collapse mode), far above 1 means the model over-trusts itself.
print(f"variance calibration E[res^2]/E[sigma^2]: {metrics['val_calibration_ratio']:.2f} "
      "(~1.0 = calibrated; also: python -m blackbox_mpc_torch calibrate <ckpt>)")


def control(propagation: str) -> float:
    # Same trained weights, different planning-time propagation: swap the config only.
    h = DynamicsHandler(config=dataclasses.replace(cfg, propagation=propagation),
                        device=args.device)
    h.set_params(handler.dynamics_params)  # reuse the trained parameters
    policy = MPCPolicy(
        action_space=env.action_space, reward_function=pendulum_reward,
        dynamics_handler=h, solver_name="CEM", num_agents=2,
        planning_horizon=20, population=240, num_elite=24, max_iterations=5,
        seed=args.seed, device=args.device,
    )
    result = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps)
    return float(np.mean(result["reward_sum"]))


r_mean = control("mean")
r_tsinf = control("ts_inf")
print(f"mean-propagation planning reward:   {r_mean:.1f}")
print(f"TS-inf (uncertainty-aware) reward:  {r_tsinf:.1f}")
