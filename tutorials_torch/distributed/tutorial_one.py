"""Tutorial: population-sharded MPC over a mesh of ranks.

Torch twin of ``tutorials/distributed/tutorial_one.py``: the same CEM solve single-device and
sharded over a ``torch.distributed`` world (each rank rolls out its block of the population,
one sum all-reduce gathers the rewards), and a check that the results agree.

Under ``torchrun`` (``torchrun --nproc-per-node=N tutorials_torch/distributed/
tutorial_one.py``) the world is torchrun's, one card per rank. Started plainly, the script
spawns ``--ranks`` processes itself, joined over ``gloo`` on ``--cpu`` or on one card they
share.
"""
import sys, pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Sharded MPC over a mesh of ranks", ranks=2)

import os
import tempfile

import numpy as np
import torch

from blackbox_mpc_torch import Bounds, make_solver, make_trajectory_evaluator
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.parallel import initialize_multihost, make_pop_mesh, make_sharded_evaluator

KWARGS = dict(planning_horizon=25, num_agents=1, population=512, num_elite=50,
              max_iterations=5)


def solve_with(evaluate, device):
    s = make_solver("CEM", Bounds.of(-2.0, 2.0, dim=1), evaluate, **KWARGS)
    state = s.init(torch.Generator(device=device).manual_seed(0))
    obs = torch.tensor([[-1.0, 0.0, 0.0]], device=device)
    with torch.no_grad():
        action, _, aux = s.solve(state, obs, 0,
                                 torch.Generator(device=device).manual_seed(args.seed))
    return action.cpu().numpy(), float(aux.expected_reward[0])


def run(rank: int, world: int, store: str | None) -> None:
    if store is not None:  # spawned here; ranks sharing one card need gloo
        initialize_multihost(f"file://{store}", world, rank, device=args.device,
                             backend="gloo")
        mesh = make_pop_mesh(device=args.device)
    else:  # torchrun's world
        initialize_multihost(device=None if args.device.type == "cuda" else args.device)
        mesh = make_pop_mesh(device=None if args.device.type == "cuda" else args.device)
    if mesh.rank == 0:
        print(f"{mesh.size} ranks, rank 0 on {mesh.device}")
    a1, r1 = solve_with(make_trajectory_evaluator(pendulum_dynamics, pendulum_reward,
                                                  device=mesh.device), mesh.device)
    a2, r2 = solve_with(make_sharded_evaluator(pendulum_dynamics, pendulum_reward, mesh),
                        mesh.device)
    if mesh.rank == 0:
        print(f"single-device action {a1.ravel()}, sharded action {a2.ravel()}")
        print(f"expected rewards: {r1:.2f} vs {r2:.2f}")
        assert np.allclose(a1, a2, atol=1e-4), "sharded solve diverged from single-device"
        print("OK: sharded == single-device")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if "WORLD_SIZE" in os.environ:
        run(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), None)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(run, args=(args.ranks, os.path.join(tmp, "store")),
                                        nprocs=args.ranks)
