"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version runs in full f32
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return -torch.sum(torch.square(ns), dim=-1) - 0.01 * torch.sum(torch.square(a), dim=-1)


def model(propagation, dtype, device, hidden=(64, 64), ensemble=2):
    config = LearnedDynamicsConfig(dim_s=3, dim_u=2, hidden=hidden, ensemble_size=ensemble,
                                   propagation=propagation, compute_dtype=getattr(torch, dtype))
    init, dyn = make_learned_dynamics(config)
    return config, init(torch.Generator().manual_seed(0)).to(device), dyn


@pytest.mark.parametrize("propagation,dtype,rows", [
    ("mean", "float32", 48), ("mean", "float32", 96), ("mean", "bfloat16", 48),
    ("ts1", "float32", 48), ("ts1", "bfloat16", 96),
])
def test_kernel_matches_plain(propagation, dtype, rows, device):
    config, dp, _ = model(propagation, dtype, device, hidden=(61, 30))  # unaligned widths
    ops = rk.make_operands(dp, config)
    g = np.random.default_rng(0)
    horizon = 6
    acts = torch.as_tensor(g.uniform(-2, 2, (horizon, rows, 2)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32, device=device)
    member = None
    if propagation == "ts1":
        member = torch.arange(2, dtype=torch.int32, device=device)
        member = member.repeat_interleave(rows // 2 // rk.TILE)
    before = rk.rollout_states.launches
    out = rk.rollout_states(config, ops, acts, s0, member)
    torch.cuda.synchronize()
    assert rk.rollout_states.launches == before + 1
    ref = rk.rollout_states_plain(config, ops, acts, s0, member)
    # f32: FMA order only; bf16: one rounded activation may land 1 ulp (2^-8) apart.
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_kernel_evaluator_matches_eager_evaluator(propagation, device):
    """Ragged rows (2 agents x 23 candidates), discount and the NaN guard, end to end."""
    config, dp, dyn = model(propagation, "float32", device)
    g = np.random.default_rng(1)
    s0 = torch.as_tensor(g.uniform(-1, 1, (2, 3)), dtype=torch.float32, device=device)
    s0[1, 0] = float("nan")
    acts = torch.as_tensor(g.uniform(-2, 2, (23, 2, 5, 2)), dtype=torch.float32, device=device)
    got = rk.make_rollout_kernel_evaluator(config, reward, discount=0.95, device=device)(
        dp, s0, acts)
    ref = make_trajectory_evaluator(lambda s, a: dyn(dp, s, a), reward, discount=0.95,
                                    device=device)(s0, acts)
    assert bool((got[:, 1] == -1e6).all())
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_bad_inputs(device):
    config, dp, _ = model("mean", "float32", device)
    ops = rk.make_operands(dp, config)
    acts = torch.zeros(4, 16, 2, device=device)
    s0 = torch.zeros(16, 3, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        rk.rollout_states(config, ops, acts.transpose(0, 1).contiguous().transpose(0, 1), s0,
                          None)
    with pytest.raises(ValueError, match="dtype"):
        rk.rollout_states(config, ops, acts.double(), s0, None)
    with pytest.raises(ValueError, match="shape"):
        rk.rollout_states(config, ops, acts, s0[:8], None)
    with pytest.raises(ValueError, match="multiple"):
        rk.rollout_states(config, ops, acts[:, :14], s0[:14], None)
