"""Tutorial: record a video of an MPC rollout.

Torch twin of ``tutorials/record_videos/tutorial_one.py``. ``record_rollout`` writes the frames
with ``imageio``, which it imports only when called; where ``imageio`` is not installed this
tutorial says so and stops.
"""
import sys, pathlib, tempfile, os, importlib.util

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Record an MPC rollout video", steps=80)

if importlib.util.find_spec("imageio") is None:
    print("imageio is not installed: record_rollout needs it to write the video")
    sys.exit(0)

from blackbox_mpc_torch import DynamicsHandler, MPCPolicy, record_rollout
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

env = NativePendulumVecEnv(num_envs=1, seed=args.seed)
policy = MPCPolicy(
    action_space=env.action_space, reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler(true_model=pendulum_dynamics, device=args.device),
    solver_name="CEM", num_agents=1, planning_horizon=25,
    population=256, num_elite=25, max_iterations=5, device=args.device,
)
path = os.path.join(tempfile.mkdtemp(prefix="bbmpc_video_"), "pendulum.gif")
reward = record_rollout(env, policy, horizon=args.steps, path=path)
print(f"wrote {path} (episode reward {reward:.1f})")
