"""Tutorial: the time-major candidate layout.

Torch twin of ``tutorials/distributed/tutorial_two.py``. The default candidate contract is
``[population, agents, horizon, dim_u]``; the horizon loop reads it time-major, so the
standard layout is transposed before every rollout. ``time_major=True`` on the solver config
AND the evaluator samples candidates as ``[horizon, population, agents, dim_u]`` instead:
same math, same sampling distribution (a different but equally random draw), no relayout.

Works for CEM, CEM-GD, PI2/MPPI, PSO and RandomSearch, including iCEM colored noise; not with
the kernel backends.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Time-major candidate layout")

import time

import numpy as np
import torch

from blackbox_mpc_torch import Bounds, make_solver, make_trajectory_evaluator
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

bounds = Bounds.of(-2.0, 2.0, dim=1)
kwargs = dict(planning_horizon=25, num_agents=4, population=512, num_elite=50,
              max_iterations=5)
obs = torch.tensor([[-1.0, 0.0, 0.0]], device=args.device).repeat(4, 1)


def sync():
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)


@torch.no_grad()
def run(time_major: bool):
    evaluate = make_trajectory_evaluator(
        pendulum_dynamics, pendulum_reward, time_major=time_major, device=args.device
    )
    s = make_solver("CEM", bounds, evaluate, time_major=time_major, **kwargs)
    state = s.init(torch.Generator(device=args.device).manual_seed(0))
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    s.solve(state, obs, 0, generator)  # warm-up
    sync()
    t0 = time.perf_counter()
    action, _, aux = s.solve(state, obs, 0, generator)
    sync()
    return (action.cpu().numpy(), float(aux.expected_reward.mean()),
            time.perf_counter() - t0)


a_std, r_std, t_std = run(time_major=False)
a_tm, r_tm, t_tm = run(time_major=True)
print(f"standard   : reward {r_std:8.2f}   {t_std * 1e3:7.2f} ms")
print(f"time-major : reward {r_tm:8.2f}   {t_tm * 1e3:7.2f} ms")
# Different (equally random) draws -> actions differ, expected quality does not: both
# layouts must land in the same reward regime on this easy shape.
assert abs(r_std - r_tm) < max(60.0, 0.5 * abs(r_std)), (r_std, r_tm)
print("OK: both layouts solve")
