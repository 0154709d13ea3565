"""Tutorial: composing the low-level API directly.

Torch twin of ``tutorials/low_level_api/tutorial_one.py``, showing what the ``MPCPolicy``
facade assembles: bounds -> evaluator -> solver triple -> solve loop. The solver's random
draws come from a ``torch.Generator`` (where JAX splits a key).
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Low-level solver API", steps=80)

import torch

from blackbox_mpc_torch import Bounds, make_solver, make_trajectory_evaluator
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

bounds = Bounds.of(-2.0, 2.0, dim=1)
evaluate = make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device=args.device)
solver = make_solver(
    "CEM", bounds, evaluate,
    planning_horizon=25, num_agents=1, population=256, num_elite=25, max_iterations=5,
)
generator = torch.Generator(device=args.device).manual_seed(args.seed)
state = solver.init(generator)

obs = torch.tensor([[-1.0, 0.0, 0.0]], device=args.device)  # hanging down
total = 0.0
with torch.no_grad():
    for t in range(args.steps):
        action, state, aux = solver.solve(state, obs, t, generator)
        nxt = pendulum_dynamics(obs, action)
        total += float(pendulum_reward(obs, action, nxt)[0])
        obs = nxt
print(f"episode reward {total:.1f}, final cos(theta) {float(obs[0,0]):+.2f}, "
      f"expected plan reward {float(aux.expected_reward[0]):.1f}")
