"""Tutorial 1: MPC with a known analytical model (pendulum swing-up).

Torch twin of ``tutorials/true_model_mpc/tutorial_one.py``: build an ``MPCPolicy`` over the
true pendulum dynamics and control the environment directly, no learning involved.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("True-model MPC on pendulum", solver="CEM", steps=100, num_envs=1)

from blackbox_mpc_torch import DynamicsHandler, MPCPolicy, perform_rollouts
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

env = NativePendulumVecEnv(num_envs=args.num_envs, seed=args.seed)
policy = MPCPolicy(
    action_space=env.action_space,
    reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler(true_model=pendulum_dynamics, device=args.device),
    solver_name=args.solver,
    num_agents=args.num_envs,
    planning_horizon=30,
    population=512,
    max_iterations=5,
    seed=args.seed,
    device=args.device,
)
result = perform_rollouts(env, policy, number_of_rollouts=1, rollout_horizon=args.steps)
print(f"{args.solver}: episode reward {result['reward_sum'][0]:.1f}, "
      f"act p50 {result['latency']['p50_s']*1e3:.1f} ms")
