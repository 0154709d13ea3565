"""Tutorial: planning beyond device memory with the fused solver family.

Torch twin of ``tutorials/beyond_hbm/tutorial_one.py``. The standard MPC pipeline holds the
candidate tensor ``[population, agents, H, U]`` in device memory; at very large populations
that tensor alone exceeds the card. The fused solvers (``rollout_backend="fused"``) generate
candidates INSIDE the CUDA kernel from a counter-based RNG and reduce elite/softmax moments by
regenerating the same stream, so the candidate tensor never exists; with a mesh each rank
handles its block of the population.

This tutorial runs SMALL shapes so it works anywhere (with ``--cpu`` the kernels' plain
versions run): the same solvers (CEM with iCEM features, PI2/MPPI, RandomSearch, sep-CMA-ES)
each plan a pendulum swing-up step on a learned-dynamics-shaped model through the one policy
facade, then the CEM solve repeats sharded over a mesh of the ranks present (torchrun's world,
or this one process). Scale ``--population`` up on a card to go beyond its memory for real.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Beyond-memory fused planning", population=512)

import os

import numpy as np

from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.learning import DynamicsHandler
from blackbox_mpc_torch.models import pendulum_reward
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
from blackbox_mpc_torch.parallel import initialize_multihost, make_pop_mesh
from blackbox_mpc_torch.policies import MPCPolicy

if "WORLD_SIZE" in os.environ:  # under torchrun: the mesh spans its ranks
    initialize_multihost(device=None if args.device.type == "cuda" else args.device)
mesh = make_pop_mesh(device=None if "WORLD_SIZE" in os.environ and args.device.type == "cuda"
                     else args.device)
device = mesh.device
handler = DynamicsHandler(config=LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(32, 32)),
                          device=device)
space = BoxSpace(low=np.asarray([-2.0]), high=np.asarray([2.0]))
obs = np.asarray([-1.0, 0.0, 0.0], np.float32)

configs = [
    ("CEM + iCEM features", "CEM",
     dict(num_elite=32, keep_elites=4, mean_as_candidate=True, execute_best=True)),
    ("PI2", "PI2", {}),
    ("MPPI (control cost)", "MPPI", {}),
    ("RandomSearch", "RandomSearch", dict(max_iterations=1)),
    ("sep-CMA-ES", "CMA-ES", dict(num_elite=32, diagonal=True)),
]
for label, solver_name, kw in configs:
    policy = MPCPolicy(
        action_space=space, reward_function=pendulum_reward, dynamics_handler=handler,
        solver_name=solver_name, planning_horizon=10, population=args.population,
        seed=args.seed, rollout_backend="fused", device=device,
        **{"max_iterations": 3, **kw},
    )
    action, _, predicted = policy.act(obs, 0)
    if mesh.rank == 0:
        print(f"{label:22s} action={float(action[0]):+.3f} "
              f"predicted_reward={float(predicted):.3f}")

# The same fused CEM sharded over the mesh: each rank generates and rolls out only its block
# of the population (D ranks: D x the capacity of one card).
ranks = mesh.size
pop_sharded = max(args.population // ranks, 32 // ranks + 1) * ranks
sharded = MPCPolicy(
    action_space=space, reward_function=pendulum_reward, dynamics_handler=handler,
    solver_name="CEM", planning_horizon=10,
    # round DOWN to a multiple of the rank count, but never below num_elite (32)
    population=pop_sharded,
    num_elite=32, max_iterations=3, seed=args.seed, rollout_backend="fused", mesh=mesh,
)
action, _, predicted = sharded.act(obs, 0)
if mesh.rank == 0:
    print(f"{'CEM sharded x' + str(ranks):22s} action={float(action[0]):+.3f} "
          f"predicted_reward={float(predicted):.3f}")

# The sharded fused family also covers iCEM population decay (one sharded launch per decayed
# per-iteration population) and sep-CMA (the single-card update, moments summed over the
# ranks).
for label, solver_name, kw in [
    ("CEM decay sharded", "CEM",
     dict(num_elite=8, max_iterations=3, population_decay=0.6)),
    ("sep-CMA sharded", "CMA-ES", dict(num_elite=32, max_iterations=3, diagonal=True)),
]:
    p = MPCPolicy(
        action_space=space, reward_function=pendulum_reward, dynamics_handler=handler,
        solver_name=solver_name, planning_horizon=10, population=pop_sharded,
        seed=args.seed, rollout_backend="fused", mesh=mesh, **kw,
    )
    action, _, predicted = p.act(obs, 0)
    if mesh.rank == 0:
        print(f"{label:22s} action={float(action[0]):+.3f} "
              f"predicted_reward={float(predicted):.3f}")
if mesh.rank == 0:
    print("OK")
