"""The split-operand 3xTF32 kernels on the CPU. ts_inf's tensor-core layers: the TF32 fragment
packer behind K2's 3xTF32 layers (``ops/rollout_kernel.py::tf32_fragment_pack``) at PETS'
widths, and a torch emulation of the split-operand product the kernel computes
(``mlp_step.cuh::dense_tf32``): each float32 operand as hi + lo, two TF32 values rounded to
nearest, ties away (``cvt.rna.tf32.f32``), and the three products lo.hi + hi.lo + hi.hi summed
in float32. The RSSM's block layers (``ops/block_gemm.py``): the K-major hi/lo pack, its
cache, the emulated sum of ``ops/csrc/block_gemm.cu``, the rule of which shapes take the kernel,
and ``models/rssm.py::block_linear`` off the card. The kernels themselves are held against
float64 and the plain versions on the card in ``test_torch_cuda_pets_kernel.py`` and
``test_torch_cuda_rssm.py``."""
import pytest
import torch

from blackbox_mpc_torch import LearnedDynamicsConfig
from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
from blackbox_mpc_torch.ops import block_gemm as bg
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


# --------------------------------------------------------------------------- the RSSM's block
# layers (``ops/block_gemm.py``): DreamerV3 size200m's two block shapes, 8 groups of 4096 ->
# 1024 and of 1024 -> 3072 a group, cut in width to deter 1024 (128 units a group) and hidden
# 64: [h_g | x0, x1, x2] 128 + 3 x 64 -> 128, and 128 -> 3 x 128.
BLOCK_SHAPES = [(8, 320, 128), (8, 128, 384), (2, 64, 256)]


def block_weight(groups, fan_in, fan_out, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((groups, fan_in, fan_out), generator=g) / fan_in ** 0.5


@pytest.mark.parametrize("groups,fan_in,fan_out", BLOCK_SHAPES,
                         ids=[f"{g}x{k}x{n}" for g, k, n in BLOCK_SHAPES])
def test_block_pack_is_k_major_hi_lo_of_the_weight(groups, fan_in, fan_out):
    """[groups, in, out] -> hi, lo [groups, out, in]: hi the TF32 rounding of the transposed
    weight, lo that of the rest, both with 13 low bits clear; hi + lo gives the weight back to
    within the split's error (2^-22 of each value: lo keeps 11 of the 13 bits hi drops)."""
    w = block_weight(groups, fan_in, fan_out)
    hi, lo = bg.block_pack(w)
    assert hi.shape == lo.shape == (groups, fan_out, fan_in) and hi.is_contiguous()
    wt = w.transpose(1, 2)
    torch.testing.assert_close(hi, tf32_rna(wt), rtol=0, atol=0)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    back = (hi + lo).transpose(1, 2)
    assert float(((back - w).abs() / w.abs().clamp_min(1e-30)).max()) <= 2.0 ** -22
    assert float((hi.transpose(1, 2) - w).abs().max()) > 0  # hi alone is not the weight


@pytest.mark.parametrize("groups,fan_in,fan_out", BLOCK_SHAPES[:2],
                         ids=[f"{g}x{k}x{n}" for g, k, n in BLOCK_SHAPES[:2]])
def test_block_split_sum_against_float64(groups, fan_in, fan_out):
    """The kernel's sum emulated: hi.hi of each 16-deep K slice added into a float32 sum,
    hi.lo + lo.hi over the whole K apart, then the bias, on 104 rows of SiLU activations.
    Its error against float64 stays within 2x that of ``torch.baddbmm`` in float32; one
    TF32 product is off by far more."""
    w = block_weight(groups, fan_in, fan_out, seed=1)
    gen = torch.Generator().manual_seed(2)
    x = torch.nn.functional.silu(torch.randn((groups, 104, fan_in), generator=gen))
    b = 0.1 * torch.randn((groups, fan_out), generator=gen)
    exact = torch.baddbmm(b.double()[:, None, :], x.double(), w.double())
    hi, lo = (t.transpose(1, 2) for t in bg.block_pack(w))
    xh, xl = split(x)
    total = torch.zeros((groups, 104, fan_out))
    for k0 in range(0, fan_in, 16):
        ks = slice(k0, k0 + 16)
        total = total + torch.bmm(xh[..., ks], hi[:, ks])
    corr = torch.bmm(xh, lo) + torch.bmm(xl, hi)
    three = (total + corr) + b[:, None, :]

    def err(y):
        return float((y.double() - exact).abs().max())

    assert err(three) <= 2 * err(torch.baddbmm(b[:, None, :], x, w))
    single = torch.baddbmm(b[:, None, :], tf32_rna(x), tf32_rna(w))
    assert err(single) >= 100 * err(torch.baddbmm(b[:, None, :], x, w))


@pytest.mark.parametrize("fan_in,fan_out,takes", [
    (4096, 1024, True), (1024, 3072, True),  # size200m's core_hidden and core_gru
    (320, 128, True), (128, 384, True),  # cut to deter 1024, hidden 64
    (256, 64, False), (64, 192, False),  # deter 512: 64 units a group
    (48, 128, False), (128, 200, False), (0, 128, False),
])
def test_which_block_shapes_take_the_kernel(fan_in, fan_out, takes):
    assert bg.takes_kernel(fan_in, fan_out) is takes


def test_the_pack_is_cached_by_identity_and_version():
    """One pack while the weight lives unchanged; an edit in place or another tensor of the
    same values packs anew; the pack of a weight that died is dropped."""
    w = block_weight(2, 64, 128, seed=3)
    calls = bg.packed.calls
    first = bg.packed(w)
    assert bg.packed(w)[0] is first[0] and bg.packed.calls == calls + 1
    w.mul_(2.0)
    hi, lo = bg.packed(w)
    assert bg.packed.calls == calls + 2
    torch.testing.assert_close(hi, bg.block_pack(w)[0], rtol=0, atol=0)
    fresh = w.clone()
    bg.packed(fresh)
    assert bg.packed.calls == calls + 3
    held = len(bg._packs)
    del fresh
    assert len(bg._packs) == held - 1


def test_an_inference_weight_is_refused_by_the_pack():
    """A weight made under ``torch.inference_mode()`` has no version counter to key a pack on:
    ``packed`` refuses it and keeps nothing; its clone outside the mode packs."""
    with torch.inference_mode():
        w = block_weight(2, 64, 128, seed=3)
    held, calls = len(bg._packs), bg.packed.calls
    with pytest.raises(ValueError, match="inference_mode"):
        bg.packed(w)
    assert (len(bg._packs), bg.packed.calls) == (held, calls)
    hi, lo = bg.packed(w.clone())
    torch.testing.assert_close(hi + lo, w.transpose(1, 2), rtol=0, atol=1e-6)


def test_the_kernel_wrapper_raises_off_the_card():
    """``block_gemm`` launches on CUDA tensors only: on the CPU it raises and counts nothing
    (``block_linear`` there is ``torch.baddbmm``)."""
    w = block_weight(8, 320, 128, seed=4)
    launches = bg.block_gemm.launches
    with pytest.raises(ValueError, match="cuda"):
        bg.block_gemm(torch.zeros((8, 3, 320)), w, torch.zeros((8, 128)))
    assert bg.block_gemm.launches == launches


def test_block_linear_on_the_cpu_is_baddbmm_bit_for_bit():
    """Off the card the layer is ``torch.baddbmm`` as it was, and counts no launch."""
    from blackbox_mpc_torch.models import rssm

    w = block_weight(8, 320, 128, seed=4)
    b = torch.randn((8, 128), generator=torch.Generator().manual_seed(5))
    x = torch.randn((8, 33, 320), generator=torch.Generator().manual_seed(6))
    launches = rssm.block_linear.tensor_core_launches
    got = rssm.block_linear(x, {"w": w, "b": b})
    assert torch.equal(got, torch.baddbmm(b[:, None, :], x, w))
    assert rssm.block_linear.tensor_core_launches == launches
