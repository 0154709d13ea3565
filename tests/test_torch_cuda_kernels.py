"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_kernels.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_torch.ops import fused_cem as fc
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


def padded(rows, ts1):
    """``rows`` rounded up to the kernels' tile for that propagation."""
    tile = rk.tile_rows(ts1)
    return -(-rows // tile) * tile


def pad_to(x, rows, dim):
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, rows - x.shape[dim]]
    return torch.nn.functional.pad(x, pad).contiguous()


def rollout(config, ops, acts, s0, member):
    """K2 on the rows padded to whole tiles (mean; a ts1 caller passes whole tiles), cut back."""
    rows = acts.shape[1]
    launch = padded(rows, member is not None)
    return rk.rollout_states(config, ops, pad_to(acts, launch, 1), pad_to(s0, launch, 0),
                             member)[:, :rows]


def fused(wrapper, config, ops, s0, mean, std, seed, rows, member=None, member_tile=None,
          **kw):
    """K4/K5 on the rows padded to whole tiles, every output cut back to ``rows``."""
    launch = padded(rows, member is not None)
    out = wrapper(config, ops, s0, mean, std, seed, launch, member,
                  member_tile or rk.tile_rows(member is not None), **kw)
    return tuple(None if o is None else (o[:, :rows] if o.dim() == 3 else o[:rows]) for o in out)


def model(propagation, dtype, device, hidden=(64, 64), ensemble=2):
    config = LearnedDynamicsConfig(dim_s=3, dim_u=2, hidden=hidden, ensemble_size=ensemble,
                                   propagation=propagation, compute_dtype=getattr(torch, dtype))
    init, dyn = make_learned_dynamics(config)
    return config, init(torch.Generator().manual_seed(0)).to(device), dyn


@pytest.mark.parametrize("propagation,dtype,rows", [
    ("mean", "float32", 48), ("mean", "float32", 100), ("mean", "bfloat16", 52),
    ("ts1", "float32", 48), ("ts1", "bfloat16", 96),
])
def test_kernel_matches_plain(propagation, dtype, rows, device):
    """Unaligned widths (61, 30; the 5-wide input pads to 8, and to 16 for the tensor cores);
    mean rows that are no multiple of the tile."""
    config, dp, _ = model(propagation, dtype, device, hidden=(61, 30))
    ops = rk.make_operands(dp, config)
    g = np.random.default_rng(0)
    horizon = 6
    acts = torch.as_tensor(g.uniform(-2, 2, (horizon, rows, 2)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32, device=device)
    member = None
    if propagation == "ts1":
        member = torch.arange(2, dtype=torch.int32, device=device)
        member = member.repeat_interleave(rows // 2 // rk.TILE_TS1)
    before = rk.rollout_states.launches
    out = rollout(config, ops, acts, s0, member)
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
    acts = torch.zeros(4, 96, 2, device=device)
    s0 = torch.zeros(96, 3, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        rk.rollout_states(config, ops, acts.transpose(0, 1).contiguous().transpose(0, 1), s0,
                          None)
    with pytest.raises(ValueError, match="dtype"):
        rk.rollout_states(config, ops, acts.double(), s0, None)
    with pytest.raises(ValueError, match="shape"):
        rk.rollout_states(config, ops, acts, s0[:8], None)
    with pytest.raises(ValueError, match="multiple"):
        rk.rollout_states(config, ops, acts[:, :50].contiguous(), s0[:50], None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ensemble", [1, 5, 7, 9])
def test_rollout_kernels_for_any_ensemble_size(ensemble, dtype, device):
    """K2 and K4 with mean propagation at E members: a cluster of min(E, 8) CTAs per tile, one
    member each, and at E = 9 a CTA that runs two. 100 rows are no multiple of the tile. Two
    runs give the same bits: the members are summed in member order, not in arrival order."""
    config, dp, _ = model("mean", dtype, device, hidden=(61, 30), ensemble=ensemble)
    ops = rk.make_operands(dp, config)
    g = np.random.default_rng(5)
    rows, horizon = 100, 6
    acts = torch.as_tensor(g.uniform(-2, 2, (horizon, rows, 2)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32, device=device)
    tol = 1e-4 if dtype == "float32" else 1e-2
    first, second = rollout(config, ops, acts, s0, None), rollout(config, ops, acts, s0, None)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, rk.rollout_states_plain(config, ops, acts, s0, None),
                               rtol=tol, atol=tol)
    a0, mean, std, seed = fused_inputs(device)
    for features in (None, make_features(device, "clip+dot")):
        kw = {} if features is None else {"features": features}
        got = fused(fc.fused_rollout, config, ops, a0, mean, std, seed, rows, **kw)
        again = fused(fc.fused_rollout, config, ops, a0, mean, std, seed, rows, **kw)
        torch.cuda.synchronize()
        ref = fc.fused_rollout_plain(config, ops, a0, mean, std, seed, rows, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[0], ref[0], rtol=tol, atol=tol)
        for a, b in zip(got[2:], ref[2:]):  # penalty, dots
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ensemble", [5, 7])
def test_ts1_kernels_for_any_ensemble_size(ensemble, device):
    """ts1 at E members: K2 on member-major blocks of two tiles each, K4 on logical tiles of two
    CTAs whose members cycle through all E, with rows that end inside a logical tile."""
    config, dp, _ = model("ts1", "float32", device, hidden=(61, 30), ensemble=ensemble)
    ops = rk.make_operands(dp, config)
    g = np.random.default_rng(6)
    rows, horizon = ensemble * 2 * rk.TILE_TS1, 6
    acts = torch.as_tensor(g.uniform(-2, 2, (horizon, rows, 2)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32, device=device)
    member = torch.arange(ensemble, dtype=torch.int32, device=device).repeat_interleave(2)
    torch.testing.assert_close(rollout(config, ops, acts, s0, member),
                               rk.rollout_states_plain(config, ops, acts, s0, member),
                               rtol=1e-4, atol=1e-4)
    a0, mean, std, seed = fused_inputs(device)
    member_tile, rows = 2 * rk.TILE_TS1, 100
    member = torch.arange(-(-rows // member_tile), device=device).remainder(ensemble).int()
    got = fused(fc.fused_rollout, config, ops, a0, mean, std, seed, rows, member, member_tile)
    ref = fc.fused_rollout_plain(config, ops, a0, mean, std, seed, rows, member, member_tile)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("propagation", ["mean", "ts1"])
@pytest.mark.parametrize("hidden,activation,more", [
    ((), "relu", {}),  # the head alone: no hidden layer, so no free buffer for partial sums
    ((40, 24, 12), "gelu", dict(normalized=False, predict_delta=False)),
])
def test_kernel_on_other_network_shapes(hidden, activation, more, propagation, dtype, device):
    """No hidden layer, three narrow ones (every layer splits K in float32), relu and gelu,
    no normalizer, absolute next-state prediction."""
    config = LearnedDynamicsConfig(dim_s=3, dim_u=2, hidden=hidden, ensemble_size=3,
                                   propagation=propagation, activation=activation,
                                   compute_dtype=getattr(torch, dtype), **more)
    dp = make_learned_dynamics(config)[0](torch.Generator().manual_seed(0)).to(device)
    ops = rk.make_operands(dp, config)
    g = np.random.default_rng(7)
    ts1 = propagation == "ts1"
    rows, horizon = (3 * 2 * rk.TILE_TS1 if ts1 else 70), 5
    acts = torch.as_tensor(g.uniform(-2, 2, (horizon, rows, 2)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.uniform(-1, 1, (rows, 3)), dtype=torch.float32, device=device)
    member = None
    if ts1:
        member = torch.arange(3, dtype=torch.int32, device=device).repeat_interleave(2)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(rollout(config, ops, acts, s0, member),
                               rk.rollout_states_plain(config, ops, acts, s0, member),
                               rtol=tol, atol=tol)


def test_shapes_beyond_shared_memory_are_refused(device):
    """A tile whose buffers exceed the CTA's 227 KB raises; nothing falls back."""
    config, dp, _ = model("mean", "float32", device, hidden=(640, 640), ensemble=1)
    ops = rk.make_operands(dp, config)
    rows = rk.TILE_MEAN
    acts = torch.zeros(2, rows, 2, device=device)
    s0 = torch.zeros(rows, 3, device=device)
    before = rk.rollout_states.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        rk.rollout_states(config, ops, acts, s0, None)
    assert rk.rollout_states.launches == before


# ---------------------------------------------------------------- K4-K6: the fused CEM kernels


def fused_inputs(device, agents=3, horizon=6, seed=2**31 - 2):
    g = np.random.default_rng(2)
    s0 = torch.as_tensor(g.uniform(-1, 1, (agents, 3)), dtype=torch.float32, device=device)
    mean = torch.as_tensor(g.uniform(-0.5, 0.5, (agents, horizon * 2)), dtype=torch.float32,
                           device=device)
    std = torch.as_tensor(g.uniform(0.1, 0.6, (agents, horizon * 2)), dtype=torch.float32,
                          device=device)
    return s0, mean, std, torch.tensor([seed], dtype=torch.int32, device=device)


@pytest.mark.parametrize("propagation,dtype,rows,streamed", [
    ("mean", "float32", 48, False), ("mean", "float32", 272, False),
    ("mean", "bfloat16", 272, False), ("ts1", "float32", 272, False),
    ("mean", "float32", 272, True),
])
def test_fused_rollout_matches_plain(propagation, dtype, rows, streamed, device):
    """272 rows for 3 agents: the rows do not split evenly among the agents."""
    config, dp, _ = model(propagation, dtype, device, hidden=(61, 30))
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    member, member_tile = None, None
    if propagation == "ts1":
        member_tile = 2 * rk.TILE_TS1  # a logical tile of two CTAs; its members alternate
        member = torch.arange(-(-rows // member_tile), device=device).remainder(2).int()
    wrapper = fc.fused_rollout_streamed if streamed else fc.fused_rollout
    before = wrapper.launches
    states, actions = fused(wrapper, config, ops, s0, mean, std, seed, rows, member, member_tile)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref_states, ref_actions = fc.fused_rollout_plain(
        config, ops, s0, mean, std, seed, rows, member, member_tile or rk.TILE_TS1,
        streamed=streamed)
    # the drawn actions: logf/cosf of the kernel and of torch's CUDA ops may differ in an ulp
    torch.testing.assert_close(actions, ref_actions, rtol=0, atol=1e-6)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(states, ref_states, rtol=tol, atol=tol)


def test_fused_rollout_block_and_streamed_give_the_same_rewards(device):
    """K4 and K5 draw the same actions from the same counters and roll them out the same way:
    the rewards of 270 rows (ragged) agree, as do the states and actions behind them."""
    config, dp, _ = model("mean", "float32", device)
    s0, mean, std, seed = fused_inputs(device)
    kw = dict(horizon=6, agents=3, population=90)
    block, _ = fc.make_fused_cem_kernels(config, reward, **kw)
    streamed, _ = fc.make_fused_cem_kernels(config, reward, streamed=True, **kw)
    before = (fc.fused_rollout.launches, fc.fused_rollout_streamed.launches)
    args = (dp, s0, mean.reshape(3, 6, 2), std.reshape(3, 6, 2), seed)
    torch.testing.assert_close(streamed(*args), block(*args), rtol=1e-6, atol=1e-6)
    assert (fc.fused_rollout.launches, fc.fused_rollout_streamed.launches) == (
        before[0] + 1, before[1] + 1)
    ops = rk.make_operands(dp, config)
    a = fused(fc.fused_rollout, config, ops, s0, mean, std, seed, 272)
    b = fused(fc.fused_rollout_streamed, config, ops, s0, mean, std, seed, 272)
    torch.testing.assert_close(b[1], a[1], rtol=0, atol=0)
    torch.testing.assert_close(b[0], a[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weights", ["elite_mask", "softmax"])
def test_elite_moments_matches_plain_and_repeats_bit_for_bit(weights, device):
    _, mean, std, seed = fused_inputs(device, agents=2, horizon=50)
    population = 1000  # 125 rows for each CTA of a cluster of 8
    g = np.random.default_rng(3)
    if weights == "elite_mask":
        w = np.zeros((population, 2), np.float32)
        for a in range(2):
            w[g.choice(population, 50, replace=False), a] = 1.0
    else:
        logits = g.normal(size=(population, 2))
        w = (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)
    w = torch.as_tensor(w.reshape(-1), device=device)
    before = fc.elite_moments.launches
    first = fc.elite_moments(std, w, seed)
    second = fc.elite_moments(std, w, seed)
    torch.cuda.synchronize()
    assert fc.elite_moments.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # sums in a fixed order, no atomics
    for got, ref in zip(first, fc.elite_moments_plain(std, w, seed)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_fused_kernels_rewards_match_cpu(propagation, device):
    """make_fused_cem_kernels end to end on the card (ragged 270 rows, ts1 by logical tiles of
    8) against the same closures on CPU tensors, which take the plain versions."""
    config, dp, _ = model(propagation, "float32", device)
    s0, mean, std, _ = fused_inputs(device)
    rr, em = fc.make_fused_cem_kernels(config, reward, horizon=6, agents=3, population=90, tile=8)
    got = rr(dp, s0, mean.reshape(3, 6, 2), std.reshape(3, 6, 2), 77)
    ref = rr(dp.to("cpu"), s0.cpu(), mean.cpu().reshape(3, 6, 2), std.cpu().reshape(3, 6, 2), 77)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    mask = (got >= got.topk(9, dim=0).values[-1]).float()  # 9 elites per agent
    got_m = em(mean, std, 77, mask)
    ref_m = em(mean.cpu(), std.cpu(), 77, mask.cpu())
    for a, b in zip(got_m, ref_m):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_fused_wrappers_reject_bad_inputs(device):
    config, dp, _ = model("mean", "float32", device)
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    with pytest.raises(ValueError, match="seed is on cpu"):
        fc.fused_rollout(config, ops, s0, mean, std, seed.cpu(), 48)
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_rollout(config, ops, s0, mean.double(), std, seed, 48)
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_rollout(config, ops, s0, mean, std, seed.long(), 48)
    with pytest.raises(ValueError, match="shape"):
        fc.fused_rollout_streamed(config, ops, s0[:2], mean, std, seed, 48)
    with pytest.raises(ValueError, match="multiple"):
        fc.fused_rollout(config, ops, s0, mean, std, seed, 46)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_rollout(config, ops, s0, mean.t().contiguous().t(), std, seed, 48)
    w = torch.ones(48 * 3, device=device)
    with pytest.raises(ValueError, match="seed is on cpu"):
        fc.elite_moments(std, w, seed.cpu())
    with pytest.raises(ValueError, match="dtype"):
        fc.elite_moments(std, w.double(), seed)
    with pytest.raises(ValueError, match="population"):
        fc.elite_moments(std, w[:-1], seed)


# ---------------------------------------------------------------- the options of K4 and K6

HORIZON, AGENTS, POPULATION = 6, 3, 90  # 270 rows: the grid pads them to 272


def make_features(device, flags, agents=AGENTS, horizon=HORIZON, population=POPULATION,
                  slots=4):
    """``fc.Features`` with the options named in ``flags`` ("colored+extra", "clip+dot", ...)."""
    g = np.random.default_rng(4)
    hu = horizon * 2
    kw = {}
    if "colored" in flags:
        basis2 = torch.as_tensor(fc._colored_basis2(horizon, 2, 2.0), device=device)
        kw.update(basis2=basis2, basis=basis2[:2 * (horizon // 2 + 1), ::2].contiguous())
    if "uniform" in flags:
        kw["sampling"] = "uniform"
    if "clip" in flags:  # narrow against std 0.1-0.6 around a mean in +/-0.5: many draws clip
        kw["clip"] = torch.tensor([[-0.4, -0.3], [0.5, 0.35]], device=device)
    if "extra" in flags:
        kw["extra"] = torch.as_tensor(g.uniform(-1, 1, (slots * agents, hu)),
                                      dtype=torch.float32, device=device)
        kw["population"] = population
    if "dot" in flags:
        kw["gvec"] = torch.as_tensor(g.normal(size=(agents, hu)), dtype=torch.float32,
                                     device=device)
    return fc.Features(**kw)


@pytest.mark.parametrize("flags,propagation,dtype", [
    ("colored", "mean", "float32"), ("uniform", "mean", "float32"), ("clip", "mean", "float32"),
    ("clip+dot", "mean", "float32"), ("extra", "mean", "float32"),
    ("colored+extra", "mean", "float32"), ("extra+dot", "mean", "float32"),
    ("colored+clip+dot", "mean", "bfloat16"), ("clip+dot", "ts1", "float32"),
    ("colored+extra", "ts1", "float32"),
])
def test_fused_rollout_options_match_plain(flags, propagation, dtype, device):
    """Every option of K4 at 272 rows (270 real ones for 3 agents: the rows above them, and the
    grid's padding to whole tiles, lie past the injected slots and must not read ``extra``),
    also under ts1."""
    config, dp, _ = model(propagation, dtype, device, hidden=(61, 30))
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    features = make_features(device, flags)
    member, member_tile = None, rk.TILE_TS1
    if propagation == "ts1":
        member = torch.arange(272 // member_tile, device=device).remainder(2).int()
    before = fc.fused_rollout.launches
    got = fused(fc.fused_rollout, config, ops, s0, mean, std, seed, 272, member, member_tile,
                features=features)
    torch.cuda.synchronize()
    assert fc.fused_rollout.launches == before + 1
    ref = fc.fused_rollout_plain(config, ops, s0, mean, std, seed, 272, member, member_tile,
                                 features=features)
    # White and uniform draws are the plain version's bits; the colored contraction and row
    # statistics sum in another order than torch's matmul and mean (a few ulp of z <= 2).
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5 if "colored" in flags else 1e-6)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got[0], ref[0], rtol=tol, atol=tol)
    for flag, a, b in (("clip", got[2], ref[2]), ("dot", got[3], ref[3])):  # penalty, dots
        assert (a is not None) == (b is not None) == (flag in flags)
        if flag in flags:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if "clip" in flags:
        lo, hi = features.clip
        assert bool(((got[1] >= lo) & (got[1] <= hi)).all()) and float(got[2].max()) > 0
    if "extra" in flags:  # the injected rows roll out `extra` itself
        injected = got[1][:, (POPULATION - 4) * AGENTS:POPULATION * AGENTS]
        want = features.extra.reshape(4 * AGENTS, HORIZON, 2).transpose(0, 1)
        assert torch.equal(injected, want)


@pytest.mark.parametrize("flags", ["colored", "uniform", "clip", "extra", "colored+extra",
                                   "colored+clip"])
def test_elite_moments_options_match_plain_and_repeat_bit_for_bit(flags, device):
    agents, horizon, population = 2, 50, 1000
    _, mean, std, seed = fused_inputs(device, agents=agents, horizon=horizon)
    features = make_features(device, flags, agents, horizon, population, slots=6)
    g = np.random.default_rng(3)
    logits = g.normal(size=(population, agents))
    w = (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)
    w = torch.as_tensor(w.reshape(-1), device=device)
    before = fc.elite_moments.launches
    first = fc.elite_moments(std, w, seed, mean, features)
    second = fc.elite_moments(std, w, seed, mean, features)
    torch.cuda.synchronize()
    assert fc.elite_moments.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # sums in a fixed order, no atomics, with every option
    for got, ref in zip(first, fc.elite_moments_plain(std, w, seed, mean, features)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_elite_moments_regenerates_the_rows_of_fused_rollout(device):
    """K6 sees K4's bits: with a one-hot weight on one row, the colored + clipped centered sum
    is that row's rolled-out actions less the mean, to the last bit."""
    config, dp, _ = model("mean", "float32", device)
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    features = make_features(device, "colored+clip")
    _, actions, _, _ = fused(fc.fused_rollout, config, ops, s0, mean, std, seed, 272,
                             features=features)
    for row in (0, 131, 269):
        w = torch.zeros(POPULATION * AGENTS, device=device)
        w[row] = 1.0
        csum, _ = fc.elite_moments(std, w, seed, mean, features)
        want = actions[:, row].reshape(-1) - mean[row % AGENTS]
        assert torch.equal(csum[row % AGENTS], want)


@pytest.mark.parametrize("options", [
    dict(colored_noise_beta=2.0, extra_slots=3), dict(sampling="uniform"),
    dict(clip_bounds=(np.array([-0.4, -0.3]), np.array([0.5, 0.35])), aux_dot=True),
    dict(colored_noise_beta=1.0, clip_bounds=(np.array([-0.4, -0.3]), np.array([0.5, 0.35]))),
])
def test_fused_kernels_options_match_cpu(options, device):
    """make_fused_cem_kernels with each solver's flag set, card against CPU closures."""
    config, dp, _ = model("mean", "float32", device)
    s0, mean, std, _ = fused_inputs(device)
    mean, std = mean.reshape(AGENTS, HORIZON, 2), std.reshape(AGENTS, HORIZON, 2)
    rr, em = fc.make_fused_cem_kernels(config, reward, horizon=HORIZON, agents=AGENTS,
                                       population=POPULATION, tile=8, **options)
    g = np.random.default_rng(6)
    kw = {}
    if options.get("extra_slots"):
        kw["extra"] = torch.as_tensor(g.uniform(-1, 1, (3, AGENTS, HORIZON * 2)),
                                      dtype=torch.float32, device=device)
    rr_kw = dict(kw)
    if options.get("aux_dot"):
        rr_kw["gvec"] = torch.as_tensor(g.normal(size=(AGENTS, HORIZON * 2)),
                                        dtype=torch.float32, device=device)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    got = rr(dp, s0, mean, std, 77, **rr_kw)
    ref = rr(dp.to("cpu"), s0.cpu(), mean.cpu(), std.cpu(), 77, **cpu(rr_kw))
    if options.get("aux_dot"):
        torch.testing.assert_close(got[1].cpu(), ref[1], rtol=1e-4, atol=1e-4)
        got, ref = got[0], ref[0]
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    weights = torch.softmax(got, dim=0)
    for a, b in zip(em(mean, std, 77, weights, **kw),
                    em(mean.cpu(), std.cpu(), 77, weights.cpu(), **cpu(kw))):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_fused_option_inputs_are_checked(device):
    config, dp, _ = model("mean", "float32", device)
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    good = make_features(device, "colored+extra+dot")

    def roll(**changes):
        return fc.fused_rollout(config, ops, s0, mean, std, seed, padded(272, False),
                                features=dataclasses.replace(good, **changes))

    with pytest.raises(ValueError, match="basis has shape"):
        roll(basis=good.basis[:-1].contiguous())
    with pytest.raises(ValueError, match="extra is on cpu"):
        roll(extra=good.extra.cpu())
    with pytest.raises(ValueError, match="fresh candidate"):
        roll(population=4)
    with pytest.raises(ValueError, match="gvec has shape"):
        roll(gvec=good.gvec[:, :-1].contiguous())
    with pytest.raises(ValueError, match="clip has shape"):
        roll(clip=torch.zeros(2, 3, device=device))
    with pytest.raises(ValueError, match="normal sampling only"):
        roll(sampling="uniform")
    w = torch.ones(POPULATION * AGENTS, device=device)
    with pytest.raises(ValueError, match="needs mean"):
        fc.elite_moments(std, w, seed, None, make_features(device, "clip"))
    with pytest.raises(ValueError, match="features.population"):
        fc.elite_moments(std, w[:30], seed, mean, make_features(device, "extra"))


# ---------------------------------------------------------------- K3 on its own, and K6 by weight


@pytest.mark.parametrize("flags", ["white", "uniform", "colored"])
def test_draw_rows_gives_the_draws_of_fused_rollout(flags, device):
    """At mean 0 and std 1 the actions K4 rolls out are its draws: draw_rows gives them bit for
    bit at rows of the first and the last tile (the last holds the grid's padding rows), and
    its plain version's bits (white, uniform) or within a few ulp of z <= 2 (colored)."""
    config, dp, _ = model("mean", "float32", device)
    ops = rk.make_operands(dp, config)
    s0, mean, std, seed = fused_inputs(device)
    mean, std = torch.zeros_like(mean), torch.ones_like(std)
    features = make_features(device, "" if flags == "white" else flags)
    rows = padded(272, False)
    out = fc.fused_rollout(config, ops, s0, mean, std, seed, rows, None, rk.TILE_MEAN,
                           features=None if flags == "white" else features)
    at = torch.tensor([0, 1, 47, 48, 131, 269, rows - 1], dtype=torch.int32, device=device)
    before = fc.draw_rows.launches
    got = fc.draw_rows(seed, at, HORIZON * 2, features.basis, features.sampling)
    torch.cuda.synchronize()
    assert fc.draw_rows.launches == before + 1
    want = out[1][:, at.long()].transpose(0, 1).reshape(len(at), -1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    far = torch.as_tensor(np.random.default_rng(9).integers(0, 2_000_000, 40), device=device)
    got = fc.draw_rows(seed, far, HORIZON * 2, features.basis, features.sampling)
    ref = fc._mirror_z(seed, far, HORIZON * 2, features.basis2, features.sampling)
    if flags == "colored":
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-6)
    else:
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_draw_rows_rejects_rows_on_another_device(device):
    _, _, _, seed = fused_inputs(device)
    with pytest.raises(ValueError, match="row_ids is on cpu"):
        fc.draw_rows(seed, torch.arange(4), 12)
    with pytest.raises(ValueError, match="row_ids is on"):
        fc.draw_rows(seed.cpu(), torch.arange(4, device=device), 12)
    with pytest.raises(ValueError, match="dtype"):
        fc.draw_rows(seed.long(), torch.arange(4, device=device), 12)


def moment_weights(kind, population, agents, g):
    """[population * agents] weights: "zeros", "single" (one row of weight), "mask" (a 0/1
    mask of 50 elites per agent), "softmax", or "logrank" (sep-CMA's: log-rank weights of the
    best 50 by a random ranking, zero after)."""
    w = np.zeros((population, agents), np.float32)
    for a in range(agents):
        if kind == "single":
            w[g.integers(population), a] = 0.5
        elif kind == "mask":
            w[g.choice(population, 50, replace=False), a] = 1.0
        elif kind == "softmax":
            e = np.exp(g.normal(0, 2, population))
            w[:, a] = e / e.sum()
        elif kind == "logrank":
            ranks = np.log(50.5) - np.log(np.arange(1, 51))
            w[g.permutation(population)[:50], a] = ranks / ranks.sum()
    return w.reshape(-1)


@pytest.mark.parametrize("agents", [1, 3])
@pytest.mark.parametrize("kind", ["zeros", "single", "mask", "softmax", "logrank"])
def test_elite_moments_for_every_kind_of_weights(kind, agents, device):
    """K6 draws only the rows of weight: with no such row the sums are 0, and a population
    (1003) that the cluster of 8 CTAs does not split evenly. Two runs, the same bits."""
    population, horizon = 1003, 50
    _, mean, std, seed = fused_inputs(device, agents=agents, horizon=horizon)
    w = torch.as_tensor(moment_weights(kind, population, agents, np.random.default_rng(11)),
                        device=device)
    first = fc.elite_moments(std, w, seed)
    second = fc.elite_moments(std, w, seed)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for got, ref in zip(first, fc.elite_moments_plain(std, w, seed)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if kind == "zeros":
        assert not bool(first[0].any()) and not bool(first[1].any())


@pytest.mark.parametrize("kind", ["zeros", "single", "mask", "logrank"])
@pytest.mark.parametrize("flags", ["uniform", "clip", "extra", "colored+extra", "colored+clip"])
def test_elite_moments_options_for_sparse_weights(flags, kind, device):
    """Every option set with weights that leave most rows out: the rows kernel (colored) and
    the per-element kernel skip them alike, injected rows of weight included."""
    agents, horizon, population = 3, 50, 1003
    _, mean, std, seed = fused_inputs(device, agents=agents, horizon=horizon)
    features = make_features(device, flags, agents, horizon, population, slots=6)
    w = moment_weights(kind, population, agents, np.random.default_rng(12))
    if kind == "single" and "extra" in flags:
        w[-agents:] = 0.25  # the last injected slot carries weight for every agent
    w = torch.as_tensor(w, device=device)
    first = fc.elite_moments(std, w, seed, mean, features)
    second = fc.elite_moments(std, w, seed, mean, features)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for got, ref in zip(first, fc.elite_moments_plain(std, w, seed, mean, features)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
