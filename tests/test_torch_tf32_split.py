"""ts_inf's tensor-core layers on the CPU: the TF32 fragment packer behind K2's 3xTF32 layers
(``ops/rollout_kernel.py::tf32_fragment_pack``) at PETS' widths, and a torch emulation of the
split-operand product the kernel computes (``mlp_step.cuh::dense_tf32``): each float32 operand
as hi + lo, two TF32 values rounded to nearest, ties away (``cvt.rna.tf32.f32``), and the
three products lo.hi + hi.lo + hi.hi summed in float32. The kernel itself is held against the
plain version on the card in ``test_torch_cuda_pets_kernel.py``."""
import pytest
import torch

from blackbox_mpc_torch import LearnedDynamicsConfig
from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.ops.measure import PETS, pets_params

torch.set_num_threads(1)

PETS_WIDTHS = (24, 200, 200, 200, 200, 36)  # S + U, 4 x 200, the head [mean S | log-variance S]
LAYERS = list(zip(PETS_WIDTHS[:-1], PETS_WIDTHS[1:]))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def unpack(flat: torch.Tensor, e: int, k: int, n: int) -> torch.Tensor:
    """The inverse of ``tf32_fragment_pack``: ``[E, K8, N16]``."""
    kp, np_ = -(-k // 8) * 8, -(-n // 16) * 16
    frags = flat.reshape(e, np_ // 16, kp // 8, 8, 4, 2, 2)  # [E, mt, kt, g, t, j, mh]
    return frags.permute(0, 2, 4, 5, 1, 6, 3).reshape(e, kp, np_)  # [E, kt, t, j, mt, mh, g]


@pytest.mark.parametrize("k,n", LAYERS, ids=[f"{k}x{n}" for k, n in LAYERS])
def test_tf32_pack_is_a_permutation_of_the_padded_block(k, n):
    """Each of PETS' layers, 5 members: the pack unpacks to the block zero-padded to K8 x N16
    (24 -> 208, 200 -> 208, 200 -> 48), holds the same values and nothing else."""
    g = torch.Generator().manual_seed(k * 1000 + n)
    w = torch.randn((5, k, n), generator=g)
    packed = rk.tf32_fragment_pack(w)
    kp, np_ = -(-k // 8) * 8, -(-n // 16) * 16
    assert packed.numel() == 5 * kp * np_
    padded = unpack(packed, 5, k, n)
    torch.testing.assert_close(padded[:, :k, :n], w, rtol=0, atol=0)
    assert float(padded[:, k:].abs().sum()) == 0.0 and float(padded[:, :, n:].abs().sum()) == 0.0
    full = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k)).reshape(-1)
    torch.testing.assert_close(packed.sort().values, full.sort().values, rtol=0, atol=0)


def test_tf32_pack_lane_layout():
    """Lane g*4 + t of tile (mt, kt) holds W[8 kt + 2t + j, 16 mt + g + 8 mh] at register
    2j + mh, 16 bytes a lane, the tiles m-major."""
    w = torch.arange(16 * 32, dtype=torch.float32).reshape(1, 16, 32)  # K = 16, N = 32
    packed = rk.tf32_fragment_pack(w).reshape(2, 2, 32, 4)  # [mt, kt, lane, register]
    for mt in range(2):
        for kt in range(2):
            for lane in (0, 5, 18, 31):
                g, t = divmod(lane, 4)
                for j in range(2):
                    for mh in range(2):
                        want = w[0, 8 * kt + 2 * t + j, 16 * mt + g + 8 * mh]
                        assert float(packed[mt, kt, lane, 2 * j + mh]) == float(want)


def test_make_operands_packs_ts_inf_for_the_tensor_cores():
    """A ts_inf net packs its float32 weights in TF32 fragment order and the operands pass
    the launch's check; a mean net of the same widths keeps the plain [E, K, N] blocks."""
    config = LearnedDynamicsConfig(**PETS)
    dp = pets_params(config, torch.device("cpu"))
    ops = rk.make_operands(dp, config)
    assert ops.widths == PETS_WIDTHS
    per_member = sum(-(-k // 8) * 8 * (-(-n // 16) * 16) for k, n in LAYERS)
    assert ops.packed_w.dtype == torch.float32 and ops.packed_w.numel() == 5 * per_member
    assert rk.check_operands(config, ops, torch.device("cpu")) == PETS_WIDTHS
    first = unpack(ops.packed_w[: 5 * 24 * 208], 5, 24, 200)
    torch.testing.assert_close(first[:, :24, :200], dp.params["net"][0]["w"], rtol=0, atol=0)
    mean = LearnedDynamicsConfig(**dict(PETS, probabilistic=False, propagation="mean",
                                        learn_logvar_bounds=False, activation="tanh"))
    mean_dp = make_learned_dynamics(mean)[0](torch.Generator().manual_seed(0))
    mean_ops = rk.make_operands(mean_dp, mean)
    assert mean_ops.packed_w.numel() == 5 * sum(k * n for k, n in zip(
        mean_ops.widths[:-1], mean_ops.widths[1:]))


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {one + 2 ** -12: one, one + 2 ** -11: one + 2 ** -10,
             -(one + 2 ** -11): -(one + 2 ** -10), one + 3 * 2 ** -12: one + 2 ** -10,
             0.0: 0.0, 3.0: 3.0}
    x = torch.tensor(list(cases), dtype=torch.float32)
    torch.testing.assert_close(tf32_rna(x), torch.tensor(list(cases.values())), rtol=0, atol=0)
    hi, lo = split(torch.tensor([one + 2 ** -11 + 2 ** -20]))
    assert float(hi) == one + 2 ** -10 and float(hi + lo) == one + 2 ** -11 + 2 ** -20


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_product_is_float32_accurate(seed):
    """A 200 x 200 layer at PETS' weight scale (1.4 / sqrt(fan_in)) on 64 rows of swish
    activations: the 3xTF32 product's error against float64 within 2x of a plain float32
    product's, where a single TF32 product is off by far more."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((200, 200), generator=g) * 1.4 / 200 ** 0.5
    x = torch.nn.functional.silu(torch.randn((64, 200), generator=g))
    exact = x.double() @ w.double()
    xh, xl = split(x)
    wh, wl = split(w)
    three = (xh @ wl) + (xl @ wh) + (xh @ wh)  # the kernel's order: small terms first

    def err(y):
        return float((y.double() - exact).abs().max())

    assert err(three) <= 2 * err(x @ w)
    assert err(tf32_rna(x) @ tf32_rna(w)) >= 100 * err(x @ w)
