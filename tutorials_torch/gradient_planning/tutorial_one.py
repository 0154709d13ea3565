"""Tutorial: first-order planning, the Gradient and CEM-GD solvers.

Torch twin of ``tutorials/gradient_planning/tutorial_one.py``. The trajectory evaluator is a
differentiable torch loop, so the gradient of the return with respect to the action sequence
is exact, and two more solver families come for free:

1. ``Gradient``: Adam ascent from random restarts (population = restarts, not samples),
2. ``CEM-GD``: CEM finds the basin, Adam polishes the blended mean + top elites.

Both work with analytic models and learned (probabilistic-ensemble) dynamics, on the
``"eager"`` backend. Here: pendulum swing-up with the true model, all three planners on the
same budget clock.
"""
import sys, pathlib, time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Gradient & CEM-GD first-order planning", steps=80)

import torch

from blackbox_mpc_torch import Bounds, make_solver, make_trajectory_evaluator
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward

bounds = Bounds.of(-2.0, 2.0, dim=1)
evaluate = make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device=args.device)

PLANNERS = {
    # name -> solver kwargs (sampled budget vs restart budget chosen to be comparable)
    "CEM": dict(population=256, max_iterations=5, num_elite=25),
    "Gradient": dict(population=32, max_iterations=20, learning_rate=0.2),
    "CEM-GD": dict(population=256, max_iterations=5, num_elite=25,
                   gd_iterations=10, gd_learning_rate=0.05),
}

for name, kw in PLANNERS.items():
    solver = make_solver(name, bounds, evaluate, planning_horizon=25, num_agents=1, **kw)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    state = solver.init(generator)
    obs = torch.tensor([[-1.0, 0.0, 0.0]], device=args.device)  # hanging straight down
    total = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():  # the first-order solvers enable autograd inside their polish
        for t in range(args.steps):
            action, state, aux = solver.solve(state, obs, t, generator)
            nxt = pendulum_dynamics(obs, action)
            total += float(pendulum_reward(obs, action, nxt)[0])
            obs = nxt
    dt = time.perf_counter() - t0
    print(f"{name:9s} return {total:8.1f}  final cos(theta) {float(obs[0, 0]):+.3f}  "
          f"({dt / args.steps * 1e3:.1f} ms/step incl. host loop)")
