"""Tutorial 2: switching solvers on a live policy.

Torch twin of ``tutorials/true_model_mpc/tutorial_two.py`` (``switch_optimizer``): run CEM for
a while, then swap to PI2 without rebuilding the dynamics wiring.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Solver switching on pendulum", steps=60)

from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

env = NativePendulumVecEnv(num_envs=1, seed=args.seed)
policy = MPCPolicy(
    action_space=env.action_space,
    reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler(true_model=pendulum_dynamics, device=args.device),
    solver_name="CEM",
    num_agents=1,
    planning_horizon=25,
    population=256,
    num_elite=25,
    max_iterations=5,
    device=args.device,
)
obs = env.reset_down()
total = 0.0
for t in range(args.steps):
    if t == args.steps // 2:
        policy.switch_solver("PI2", population=256, max_iterations=5)
        print(f"t={t}: switched to {policy.solver_name}")
    action, _, _ = policy.act(obs, t)
    obs, reward, _, _ = env.step(action)
    total += float(reward.mean())
print(f"episode reward {total:.1f}, final cos(theta) {obs[0,0]:+.2f}")
