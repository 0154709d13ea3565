"""Tutorial: iterative MBRL with TensorBoard metrics and full checkpoint/resume.

Torch twin of ``tutorials/model_based_rl/tutorial_two.py``. The :class:`MetricsWriter` records
the scalar families of the loop (actual/predicted rewards, model error, train/val loss) and
perf counters to TensorBoard + JSONL, and ``checkpoint_dir`` + ``resume=True`` continue an
interrupted loop: model, optimizer state, normalizer, replay and loop counter included.

Run once, interrupt, run again with ``--resume``: the loop picks up at the next refinement.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Iterative MBRL with metrics + resume", refinements=3, steps=80,
             logdir="/tmp/bbmpc_torch_mbrl_tb", ckpt="/tmp/bbmpc_torch_mbrl_ckpt")
_resume = "--resume" in sys.argv  # setup() uses parse_known_args, so this passes through

import numpy as np

from blackbox_mpc_torch import (LearnedDynamicsConfig, learn_dynamics_iteratively_w_mpc,
                                perform_rollouts)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_reward
from blackbox_mpc_torch.utils.metrics import MetricsWriter

writer = MetricsWriter(args.logdir)
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
    metrics_writer=writer,
    checkpoint_dir=args.ckpt,
    resume=_resume,
    seed=args.seed,
    device=args.device,
)
final = perform_rollouts(env, policy, number_of_rollouts=2, rollout_horizon=args.steps,
                         metrics_writer=writer)
print(f"final MPC mean episode reward: {np.mean(final['reward_sum']):.1f}")
print(f"TensorBoard scalars in {args.logdir}; checkpoints in {args.ckpt}")
print(f"recorded tags: {sorted(writer.history)}")
