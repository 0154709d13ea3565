"""Port parity for K2, the fused ensemble rollout: the plain version behind the CUDA kernel's
wrapper (what runs on CPU tensors) against the JAX Pallas kernel in interpret mode and the
JAX XLA evaluator, at rtol/atol 1e-4, as tests/test_pallas.py holds the Pallas kernel. The
kernel itself is held against its plain version on the card in test_torch_cuda_kernels.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_tpu.models.normalizer import NormalizerStats
from blackbox_mpc_tpu.ops import make_pallas_rollout_evaluator
from blackbox_mpc_tpu.rollout import make_trajectory_evaluator
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator as t_make_evaluator


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


def setup(ensemble, propagation, hidden=(16, 16), normalized=True, compute_dtype="float32"):
    jcfg = LearnedDynamicsConfig(
        dim_s=3, dim_u=2, hidden=hidden, ensemble_size=ensemble, propagation=propagation,
        normalized=normalized, compute_dtype=getattr(jnp, compute_dtype),
    )
    init_model, dyn = make_learned_dynamics(jcfg)
    dp = init_model(jax.random.PRNGKey(0)).replace(stats=STATS)
    tcfg = tdyn.LearnedDynamicsConfig(
        dim_s=3, dim_u=2, hidden=hidden, ensemble_size=ensemble, propagation=propagation,
        normalized=normalized, compute_dtype=getattr(torch, compute_dtype),
    )
    params = jax.tree_util.tree_map(np.asarray, dp.params)
    stats = {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}
    tdp = dynamics_params_from_numpy(params, stats, tcfg, device="cpu")
    return jcfg, dp, dyn, tcfg, tdp


def port_rewards(tcfg, tdp, s0, acts, discount):
    ev = rk.make_rollout_kernel_evaluator(tcfg, t_reward, discount=discount, device="cpu")
    return ev(tdp, torch.as_tensor(s0), torch.as_tensor(acts)).numpy()


@pytest.mark.parametrize(
    "ensemble,propagation,pop,agents,normalized,discount",
    [
        (2, "mean", 10, 2, True, 1.0),
        (2, "mean", 7, 3, False, 0.95),  # 21 rows: ragged against the tile
        (1, "mean", 9, 2, True, 0.95),
        (2, "ts1", 9, 2, True, 1.0),     # 18 rows: each member block padded to tiles
        (2, "ts1", 22, 2, True, 0.95),
    ],
)
def test_plain_k2_matches_pallas_and_xla(ensemble, propagation, pop, agents, normalized,
                                         discount, rng):
    jcfg, dp, dyn, tcfg, tdp = setup(ensemble, propagation, normalized=normalized)
    s0 = rng.uniform(-1, 1, (agents, 3)).astype(np.float32)
    acts = rng.uniform(-2, 2, (pop, agents, 6, 2)).astype(np.float32)
    xla = make_trajectory_evaluator(partial(dyn, dp), j_reward, discount=discount)
    pal = make_pallas_rollout_evaluator(jcfg, j_reward, tile=8, discount=discount,
                                        interpret=True)
    ref_xla = np.asarray(xla(jnp.asarray(s0), jnp.asarray(acts)))
    ref_pal = np.asarray(pal(dp, jnp.asarray(s0), jnp.asarray(acts)))
    out = port_rewards(tcfg, tdp, s0, acts, discount)
    np.testing.assert_allclose(out, ref_pal, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref_xla, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_eager_evaluator_matches_xla(propagation, rng):
    _, dp, dyn, tcfg, tdp = setup(2, propagation)
    _, tdyn_fn = tdyn.make_learned_dynamics(tcfg)
    s0 = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    acts = rng.uniform(-2, 2, (9, 2, 6, 2)).astype(np.float32)
    kw = dict(discount=0.95, action_smoothness_weight=0.3)
    ref = make_trajectory_evaluator(partial(dyn, dp), j_reward, **kw)(
        jnp.asarray(s0), jnp.asarray(acts))
    out = t_make_evaluator(partial(tdyn_fn, tdp), t_reward, device="cpu", **kw)(
        torch.as_tensor(s0), torch.as_tensor(acts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # time-major candidates [H, P, A, U]: same rewards
    out_tm = t_make_evaluator(partial(tdyn_fn, tdp), t_reward, device="cpu", time_major=True,
                              **kw)(torch.as_tensor(s0),
                                    torch.as_tensor(acts).permute(2, 0, 1, 3).contiguous())
    np.testing.assert_allclose(out_tm.numpy(), out.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_plain_k2_nan_guard(propagation, rng):
    jcfg, dp, dyn, tcfg, tdp = setup(2, propagation)
    s0 = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    s0[1, 0] = np.nan  # agent 1's every rollout is NaN
    acts = rng.uniform(-2, 2, (8, 2, 4, 2)).astype(np.float32)
    ref = np.asarray(make_pallas_rollout_evaluator(jcfg, j_reward, tile=8, interpret=True)(
        dp, jnp.asarray(s0), jnp.asarray(acts)))
    out = port_rewards(tcfg, tdp, s0, acts, 1.0)
    assert np.all(out[:, 1] == -1e6) and np.all(np.isfinite(out[:, 0]))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_plain_k2_bf16_close_to_xla(rng):
    # bf16 compute: same cast order as the JAX chain; a 1-ulp (2^-8) difference in one
    # rounded activation may propagate, hence the looser tolerance.
    _, dp, dyn, tcfg, tdp = setup(2, "mean", compute_dtype="bfloat16")
    s0 = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    acts = rng.uniform(-2, 2, (9, 2, 6, 2)).astype(np.float32)
    ref = np.asarray(make_trajectory_evaluator(partial(dyn, dp), j_reward)(
        jnp.asarray(s0), jnp.asarray(acts)))
    out = port_rewards(tcfg, tdp, s0, acts, 1.0)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)


def test_kernel_evaluator_rejects_indivisible_ts1_and_bad_config():
    _, _, _, tcfg, tdp = setup(3, "ts1", hidden=(8,))
    ev = rk.make_rollout_kernel_evaluator(tcfg, t_reward, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ev(tdp, torch.zeros(1, 3), torch.zeros(7, 1, 4, 2))
    bad = tdyn.LearnedDynamicsConfig(dim_s=3, dim_u=2, activation="swish")
    with pytest.raises(ValueError, match="activation"):
        rk.make_rollout_kernel_evaluator(bad, t_reward, device="cpu")


def test_kernel_evaluator_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tcfg, _ = setup(2, "mean")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rk.make_rollout_kernel_evaluator(tcfg, t_reward)


def test_make_operands_pads_to_kernel_widths():
    _, _, _, tcfg, tdp = setup(2, "mean", hidden=(15, 9))
    ops = rk.make_operands(tdp, tcfg)
    assert ops.widths == (8, 16, 12, 4)  # S+U=5, 15, 9, S=3 rounded up to multiples of 4
    assert ops.packed_w.numel() == 2 * (8 * 16 + 16 * 12 + 12 * 4)
    assert ops.packed_b.numel() == 2 * (16 + 12 + 4)
    first = ops.packed_w[: 2 * 8 * 16].reshape(2, 8, 16)
    torch.testing.assert_close(first[:, :5, :15], tdp.params[0]["w"])
    assert float(first[:, 5:].abs().sum()) == 0.0 and float(first[:, :, 15:].abs().sum()) == 0.0



def test_kernel_evaluator_repacks_params_changed_in_place(rng):
    """Weights and stats updated in place (as optimizer.step or copy_ do) keep the
    DynamicsParams object, so the evaluator must not plan with its earlier pack."""
    _, _, _, tcfg, tdp = setup(2, "mean")
    _, tdyn_fn = tdyn.make_learned_dynamics(tcfg)
    s0 = torch.as_tensor(rng.uniform(-1, 1, (2, 3)).astype(np.float32))
    acts = torch.as_tensor(rng.uniform(-2, 2, (8, 2, 5, 2)).astype(np.float32))
    ev = rk.make_rollout_kernel_evaluator(tcfg, t_reward, device="cpu")
    before = ev(tdp, s0, acts)
    with torch.no_grad():
        tdp.params[0]["w"].mul_(1.5)
        tdp.stats.mean_states.add_(0.5)
        tdp.stats.std_targets.mul_(2.0)
    after = ev(tdp, s0, acts)
    ref = t_make_evaluator(partial(tdyn_fn, tdp), t_reward, device="cpu")(s0, acts)
    assert not torch.allclose(after, before)
    torch.testing.assert_close(after, ref, rtol=1e-5, atol=1e-5)
