"""The parallel layer on the card: in a 1-rank NCCL world every sharded path gives the bits
of its single-device twin (the sharded fused family, the sharded eager CEM, data-parallel
training) with the same kernel launches; two ranks sharing the card over gloo act alike.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \\
        tests/test_torch_cuda_parallel.py -q
"""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.learning.trainer import flat_params
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.parallel import initialize_multihost, make_pop_mesh

# The worker by its path: on a GPU machine another package named ``tests`` may come first.
_spec = importlib.util.spec_from_file_location(
    "_torch_multiproc_worker", Path(__file__).with_name("_torch_multiproc_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

pytestmark = pytest.mark.cuda

NET = dict(dim_s=6, dim_u=2, hidden=(64, 64), ensemble_size=5)
SOLVER = dict(planning_horizon=10, population=96, max_iterations=3)
DRIVES = {
    "CEM": ("CEM", "fused", dict(num_elite=8)),
    "iCEM decay": ("CEM", "fused", dict(num_elite=8, colored_noise_beta=2.0,
                                        population_decay=0.7)),
    "PI2": ("PI2", "fused", dict()),
    "MPPI": ("MPPI", "fused", dict()),
    "RandomSearch": ("RandomSearch", "fused", dict()),
    "sep-CMA-ES": ("CMA-ES", "fused", dict(num_elite=8, diagonal=True)),
    "eager CEM": ("CEM", "eager", dict(num_elite=8)),
}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 1-rank NCCL world on the current card, for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = torch.device("cuda", torch.cuda.current_device())
    store = tmp_path_factory.mktemp("nccl") / "store"
    initialize_multihost(f"file://{store}", 1, 0, device=device)
    yield make_pop_mesh(device=device)
    torch.distributed.destroy_process_group()


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def handler_on(device, mesh=None):
    return DynamicsHandler(LearnedDynamicsConfig(**NET), seed=0, device=device, mesh=mesh)


def acts(policy, steps=3):
    counters = {k: getattr(fc, k) for k in ("fused_rollout", "elite_moments", "draw_rows")}
    for c in counters.values():
        c.launches = 0
    obs, outs = np.linspace(-0.5, 0.5, 6).astype(np.float32), []
    for t in range(steps):
        out = policy.act(obs, t)
        outs.append(np.concatenate([np.ravel(x) for x in out]))
        obs = out[1]
    return np.stack(outs), {k: c.launches for k, c in counters.items()}


@pytest.mark.parametrize("label", sorted(DRIVES))
def test_one_rank_nccl_world_is_single_device_bit_for_bit(mesh, label):
    solver_name, backend, kwargs = DRIVES[label]
    handler = handler_on(mesh.device)
    runs = [acts(MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), reward, handler, solver_name,
                           rollout_backend=backend, mesh=m, seed=1, device=mesh.device,
                           **SOLVER, **kwargs))
            for m in (None, mesh)]
    (single, single_launches), (sharded, sharded_launches) = runs
    np.testing.assert_array_equal(sharded, single)
    assert sharded_launches == single_launches
    if backend == "fused":
        assert sharded_launches["fused_rollout"] > 0


def test_data_parallel_train_is_bit_for_bit(mesh):
    rng = np.random.default_rng(0)
    obs = [rng.normal(0, 1, (21, 6)).astype(np.float32) for _ in range(4)]
    actions = [rng.uniform(-1, 1, (20, 2)).astype(np.float32) for _ in range(4)]
    runs = []
    for m in (None, mesh):
        h = handler_on(mesh.device, m)
        info = h.train(copy.deepcopy(obs), copy.deepcopy(actions), epochs=3, batch_size=16)
        runs.append(((info["train_loss"], info["val_loss"]),
                     flat_params(h.dynamics_params.params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_two_ranks_share_the_card_over_gloo(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    config = LearnedDynamicsConfig(**NET)
    dp = DynamicsHandler(config, seed=0, device="cpu").dynamics_params
    model = {"config": NET, "params": [{k: v.numpy() for k, v in layer.items()}
                                       for layer in dp.params],
             "stats": {k: getattr(dp.stats, k).numpy() for k in STATS_FIELDS}}
    ranks = worker.run_world("card", {"device": "cuda:0", "model": model}, tmp_path)
    for name in ("CEM", "RandomSearch"):
        first, second = (r["card_fused"][name] for r in ranks)
        np.testing.assert_array_equal(first["actions"], second["actions"])
        assert first["launches"] == second["launches"]
        assert first["launches"]["fused_rollout"] == (6 if name == "CEM" else 2)
        assert first["launches"]["draw_rows"] == (0 if name == "CEM" else 2)
