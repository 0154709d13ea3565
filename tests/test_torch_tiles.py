"""What the CUDA kernels' row tiles moved into Python, on CPU tensors against the JAX package:
the wrappers' padding to whole tiles, ts1's member-major grouping and scatter-back, K4's
row -> agent and row -> member maps, and the weight layout the tensor-core path reads.

The kernels have one tile per propagation (``rk.TILE_MEAN``, ``rk.TILE_TS1``). On CPU tensors
the wrappers run the plain versions on exactly the padded, regrouped rows that the kernels get
on the card, so these cases hold the layout, not the kernels (those are held to the plain
versions on the card in test_torch_cuda_kernels.py). Rewards at rtol/atol 1e-4, as the
existing parity tests of K2 and K4 state."""
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.pallas_cem as jc
import blackbox_mpc_torch.ops.fused_cem as tc
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_tpu.models.normalizer import NormalizerStats
from blackbox_mpc_tpu.rollout import make_trajectory_evaluator
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.ops import rollout_kernel as rk

S, U, H = 3, 2, 3


def j_reward(s, a, ns):
    return -jnp.sum(jnp.square(ns), axis=-1) - 0.01 * jnp.sum(jnp.square(a), axis=-1)


def t_reward(s, a, ns):
    return -torch.sum(torch.square(ns), dim=-1) - 0.01 * torch.sum(torch.square(a), dim=-1)


STATS = NormalizerStats(
    mean_states=jnp.asarray([0.1, -0.2, 0.3]),
    std_states=jnp.asarray([1.1, 0.9, 2.0]),
    mean_actions=jnp.asarray([0.05, -0.05]),
    std_actions=jnp.asarray([1.5, 0.7]),
    mean_targets=jnp.asarray([0.0, 0.01, -0.01]),
    std_targets=jnp.asarray([0.5, 0.5, 1.2]),
)


def bridged(propagation, ensemble, hidden=(8,), compute_dtype="float32"):
    """The same ensemble in both packages."""
    jcfg = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=hidden, ensemble_size=ensemble,
                                 propagation=propagation)
    init, dyn = make_learned_dynamics(jcfg)
    dp = init(jax.random.PRNGKey(0)).replace(stats=STATS)
    tcfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=hidden, ensemble_size=ensemble,
                                      propagation=propagation,
                                      compute_dtype=getattr(torch, compute_dtype))
    tdp = dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu")
    return jcfg, dp, dyn, tcfg, tdp


def test_tile_constants_agree_with_the_cuda_header():
    header = (Path(rk.__file__).parent / "csrc" / "mlp_step.cuh").read_text()
    compiled = {name: int(value) for name, value in
                re.findall(r"#define BBMPC_TILE_(MEAN|TS1) (\d+)", header)}
    assert compiled == {"MEAN": rk.TILE_MEAN, "TS1": rk.TILE_TS1}
    assert rk.tile_rows(False) == rk.TILE_MEAN and rk.tile_rows(True) == rk.TILE_TS1
    # float32 reads activations 16 bytes at a time; K4 draws a tile in sub-tiles of 8 or 4 rows
    assert rk.TILE_MEAN % 4 == 0 and rk.TILE_TS1 in (4, 8, 16, 32)
    # the JAX package's logical ts1 tiles (the default and the smoke run's) are whole tiles
    assert 256 % rk.TILE_TS1 == 0 and 128 % rk.TILE_TS1 == 0


# ------------------------------------------------------------------------ K2's evaluator


@pytest.mark.parametrize(
    "ensemble,propagation,pop,agents",
    [
        (1, "mean", 1001, 1),   # 1001 rows: one row into the last tile
        (5, "mean", 37, 1),     # fewer rows than one tile
        (7, "mean", 37, 3),     # 111 rows, agents > 1
        (9, "mean", 13, 2),     # more members than a cluster has CTAs
        (5, "ts1", 185, 1),     # 37 rows per member, each block padded to whole tiles
        (7, "ts1", 21, 3),      # 63 rows, 9 per member
        (9, "ts1", 9, 2),       # 18 rows, 2 per member: every block mostly padding
        (5, "ts1", 1001, 5),    # 5005 rows, 1001 per member
    ],
)
def test_kernel_evaluator_pads_and_regroups_like_jax(ensemble, propagation, pop, agents, rng,
                                                      monkeypatch):
    """Ragged rows against the tile, agents > 1 and every ensemble size: the evaluator's
    padding, its ts1 member-major permutation with padded blocks and the scatter-back give the
    JAX evaluator's rewards."""
    _, dp, dyn, tcfg, tdp = bridged(propagation, ensemble)
    s0 = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
    acts = rng.uniform(-2, 2, (pop, agents, H, U)).astype(np.float32)
    ref = np.asarray(make_trajectory_evaluator(partial(dyn, dp), j_reward, discount=0.95)(
        jnp.asarray(s0), jnp.asarray(acts)))
    calls = []
    real = rk.rollout_states

    def spy(config, ops, actions, s0_rows, tile_member):
        calls.append((actions.shape[1], None if tile_member is None else tile_member.clone()))
        return real(config, ops, actions, s0_rows, tile_member)

    monkeypatch.setattr(rk, "rollout_states", spy)
    ev = rk.make_rollout_kernel_evaluator(tcfg, t_reward, discount=0.95, device="cpu")
    out = ev(tdp, torch.as_tensor(s0), torch.as_tensor(acts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # what the kernel is handed: whole tiles, and for ts1 one member per tile, member-major
    (rows_launched, tile_member), = calls
    rows = pop * agents
    if propagation == "ts1":
        block = kc.round_up(rows // ensemble, rk.TILE_TS1)
        assert rows_launched == ensemble * block
        want = np.repeat(np.arange(ensemble), block // rk.TILE_TS1)
        np.testing.assert_array_equal(tile_member.numpy(), want)
    else:
        assert tile_member is None and rows_launched == kc.round_up(rows, rk.TILE_MEAN)


def test_padding_rows_do_not_change_the_real_rows(rng):
    """K2's plain version on rows padded to the mean tile equals itself on the rows alone."""
    _, _, _, tcfg, tdp = bridged("mean", 5)
    ops = rk.make_operands(tdp, tcfg)
    rows = 37
    acts = torch.as_tensor(rng.uniform(-2, 2, (H, rows, U)).astype(np.float32))
    s0 = torch.as_tensor(rng.uniform(-1, 1, (rows, S)).astype(np.float32))
    padded = kc.round_up(rows, rk.TILE_MEAN)
    acts_pad = torch.nn.functional.pad(acts, (0, 0, 0, padded - rows))
    s0_pad = torch.nn.functional.pad(s0, (0, 0, 0, padded - rows))
    torch.testing.assert_close(rk.rollout_states(tcfg, ops, acts_pad, s0_pad, None)[:, :rows],
                               rk.rollout_states(tcfg, ops, acts, s0, None), rtol=0, atol=0)


def test_rollout_states_plain_refuses_rows_that_are_not_member_major():
    _, _, _, tcfg, tdp = bridged("ts1", 5)
    ops = rk.make_operands(tdp, tcfg)
    rows = 5 * rk.TILE_TS1
    acts, s0 = torch.zeros(H, rows, U), torch.zeros(rows, S)
    member = torch.arange(5, dtype=torch.int32)
    assert rk.rollout_states_plain(tcfg, ops, acts, s0, member).shape == (H, rows, S)
    with pytest.raises(ValueError, match="member-major"):
        rk.rollout_states_plain(tcfg, ops, acts, s0, member.flip(0))


# ------------------------------------------------------------------------ K4's row maps


@pytest.mark.parametrize(
    "ensemble,propagation,agents,pop,tile",
    [
        (1, "mean", 1, 37, 8),
        (5, "mean", 3, 37, 8),      # 111 rows, agents > 1
        (9, "mean", 2, 13, 16),
        (5, "ts1", 1, 1001, 128),   # 8 logical tiles, the last one 105 rows
        (7, "ts1", 3, 41, 16),      # 123 rows in 8 logical tiles for 7 members
        (9, "ts1", 2, 37, 8),       # 74 rows in 10 logical tiles
    ],
)
def test_fused_rollout_rewards_for_any_ensemble_and_tile(ensemble, propagation, agents, pop,
                                                         tile, rng):
    """Row r belongs to agent r % A and, for ts1, to the member of its logical tile of `tile`
    rows (a multiple of the CUDA ts1 tile): the JAX kernels' rewards, in interpret mode."""
    assert tile % rk.TILE_TS1 == 0
    jcfg, dp, _, tcfg, tdp = bridged(propagation, ensemble)
    s0 = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, (agents, H, U)).astype(np.float32)
    std = rng.uniform(0.1, 0.6, (agents, H, U)).astype(np.float32)
    kw = dict(horizon=H, agents=agents, population=pop, tile=tile)
    j_rr, _ = jc.make_fused_cem_kernels(jcfg, j_reward, interpret=True, **kw)
    t_rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, **kw)
    ref = np.asarray(j_rr(dp, jnp.asarray(s0), jnp.asarray(mean), jnp.asarray(std), 4242))
    out = t_rr(tdp, torch.as_tensor(s0), torch.as_tensor(mean), torch.as_tensor(std), 4242)
    assert out.shape == (pop, agents)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    if propagation == "ts1":
        np.testing.assert_array_equal(t_rr.tile_member_ids, j_rr.tile_member_ids)
        assert t_rr.tile_rows == tile


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_logical_tile_must_be_whole_cuda_tiles(propagation):
    _, _, _, tcfg, _ = bridged(propagation, 5)
    kw = dict(horizon=H, agents=1, population=1000)
    for tile in (rk.TILE_TS1 + 4, 3 * rk.TILE_TS1 // 2, 0, -8):
        with pytest.raises(ValueError, match="multiple of the CUDA row tile"):
            tc.make_fused_cem_kernels(tcfg, t_reward, tile=tile, **kw)
    tc.make_fused_cem_kernels(tcfg, t_reward, tile=3 * rk.TILE_TS1, **kw)


def test_fused_rollout_plain_row_maps(rng):
    """K4's plain version at a row count padded to whole tiles, as the card launches it: row r
    starts from agent r % A's state and runs the member of its logical tile, the padding rows
    past the population never read the injected candidates, and the real rows do not change."""
    _, _, _, tcfg, tdp = bridged("ts1", 5)
    ops = rk.make_operands(tdp, tcfg)
    agents, pop, member_tile = 3, 21, 2 * rk.TILE_TS1
    rows = pop * agents  # 63
    rows_pad = kc.round_up(rows, rk.TILE_TS1)
    s0 = torch.as_tensor(rng.uniform(-1, 1, (agents, S)).astype(np.float32))
    mean = torch.as_tensor(rng.uniform(-0.5, 0.5, (agents, H * U)).astype(np.float32))
    std = torch.as_tensor(rng.uniform(0.1, 0.6, (agents, H * U)).astype(np.float32))
    seed = torch.tensor([77], dtype=torch.int32)
    member = torch.arange(-(-rows_pad // member_tile)).remainder(5).int()
    extra = torch.as_tensor(rng.uniform(-1, 1, (2 * agents, H * U)).astype(np.float32))
    features = tc.Features(extra=extra, population=pop)
    states, actions, _, _ = tc.fused_rollout(tcfg, ops, s0, mean, std, seed, rows_pad, member,
                                             member_tile, features=features)
    short = tc.fused_rollout(tcfg, ops, s0, mean, std, seed, rows, member, member_tile,
                             features=features)
    torch.testing.assert_close(states[:, :rows], short[0], rtol=0, atol=0)
    torch.testing.assert_close(actions[:, :rows], short[1], rtol=0, atol=0)
    # the last two population slots roll out `extra`; the padding row draws its own actions
    injected = actions[:, (pop - 2) * agents:rows].transpose(0, 1).reshape(2 * agents, -1)
    torch.testing.assert_close(injected, extra, rtol=0, atol=0)
    z = tc._mirror_z(77, torch.arange(rows, rows_pad), H * U)
    pad_agent = torch.arange(rows, rows_pad) % agents
    torch.testing.assert_close(actions[:, rows:].transpose(0, 1).reshape(rows_pad - rows, -1),
                               mean[pad_agent] + std[pad_agent] * z, rtol=0, atol=0)
    # each row against its own member's network, one step at a time
    for row in (0, 17, 40, rows - 1):
        e = int(member[row // member_tile])
        single = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,), ensemble_size=1)
        step = kc.build_step_fn(single, ops.stats, [w[e:e + 1] for w in ops.weights])
        s = s0[row % agents][None]
        for t in range(H):
            s = step(s, actions[t, row][None])
            torch.testing.assert_close(states[t, row][None], s, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------------ the packed weights


def test_fragment_pack_is_the_mma_a_fragment_order(rng):
    """Lane g*4 + t of tile (mt, kt) holds W[k, n] at n = 16 mt + g + 8 mh and
    k = 16 kt + 2 t + 8 kh + j, registers ordered (kh, mh), j fastest: a0..a3 of
    mma.m16n8k16 for A = W^T. K = 23 and N = 61 pad to 32 and 64."""
    ensemble, k, n = 2, 23, 61
    w = torch.as_tensor(rng.normal(size=(ensemble, k, n)).astype(np.float32)).bfloat16()
    packed = rk.fragment_pack(w).reshape(ensemble, 4, 2, 32, 4, 2).float().numpy()
    full = np.zeros((ensemble, 32, 64), np.float32)
    full[:, :k, :n] = w.float().numpy()
    for mt, kt, lane in [(0, 0, 0), (3, 1, 31), (2, 0, 13), (1, 1, 6)]:
        g, t = lane // 4, lane % 4
        for reg, (kh, mh) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            for j in range(2):
                want = full[:, 16 * kt + 2 * t + 8 * kh + j, 16 * mt + g + 8 * mh]
                np.testing.assert_array_equal(packed[:, mt, kt, lane, reg, j], want)
    # every element lands exactly once: the pack is a permutation of the padded block
    np.testing.assert_array_equal(np.sort(packed.reshape(ensemble, -1), axis=1),
                                  np.sort(full.reshape(ensemble, -1), axis=1))


def test_make_operands_packs_bf16_for_the_tensor_cores():
    _, _, _, tcfg, tdp = bridged("mean", 2, hidden=(15, 9), compute_dtype="bfloat16")
    ops = rk.make_operands(tdp, tcfg)
    assert ops.widths == (8, 16, 12, 4)  # the logical widths stay multiples of 4
    assert ops.packed_w.dtype == torch.bfloat16
    assert ops.packed_w.numel() == 2 * (16 * 16 + 16 * 16 + 16 * 16)  # K and N padded to 16
    assert ops.packed_b.numel() == 2 * (16 + 12 + 4)
    assert rk.check_operands(tcfg, ops, torch.device("cpu")) == ops.widths
    first = ops.packed_w[:2 * 256].reshape(2, 1, 1, 8, 4, 2, 2, 2)  # [E, mt, kt, g, t, kh, mh, j]
    unpacked = first.permute(0, 2, 5, 4, 7, 1, 6, 3).reshape(2, 16, 16)  # [E, k, n]
    want = tdp.params[0]["w"].bfloat16()
    torch.testing.assert_close(unpacked[:, :5, :15], want, rtol=0, atol=0)
    assert float(unpacked[:, 5:].abs().sum()) == 0.0
    assert float(unpacked[:, :, 15:].abs().sum()) == 0.0
    f32 = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(15, 9), ensemble_size=2)
    with pytest.raises(ValueError, match="packed_w"):
        rk.check_operands(f32, ops, torch.device("cpu"))
