"""Tutorial 3: rollout collection with TensorBoard-style metrics.

Torch twin of ``tutorials/true_model_mpc/tutorial_three.py``: collect rollouts while streaming
actual/predicted reward scalars to a ``MetricsWriter`` (TensorBoard + JSONL).
"""
import sys, pathlib, tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Rollout collection with metrics", rollouts=2, steps=50)

from blackbox_mpc_torch import DynamicsHandler, MPCPolicy, MetricsWriter, perform_rollouts
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

log_dir = tempfile.mkdtemp(prefix="bbmpc_tb_")
writer = MetricsWriter(log_dir)
env = NativePendulumVecEnv(num_envs=2, seed=args.seed)
policy = MPCPolicy(
    action_space=env.action_space,
    reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler(true_model=pendulum_dynamics, device=args.device),
    solver_name="CEM",
    num_agents=2,
    planning_horizon=25,
    population=256,
    num_elite=25,
    max_iterations=5,
    metrics_writer=writer,
    device=args.device,
)
result = perform_rollouts(
    env, policy, number_of_rollouts=args.rollouts, rollout_horizon=args.steps,
    metrics_writer=writer,
)
writer.flush()
print("episode rewards:", [f"{r:.1f}" for r in result["reward_sum"]])
print("logged tags:", sorted(writer.history))
print("TensorBoard logdir:", log_dir)
