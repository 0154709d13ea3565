"""K2: the fused ensemble-MLP rollout as a hand-written CUDA kernel, with its plain version.

Replaces ``blackbox_mpc_tpu/ops/pallas_rollout.py::make_pallas_rollout_evaluator`` and, inside
it, ``ops/_kernel_common.py::build_step_fn``. The kernel (``ops/csrc/rollout.cu``) rolls a
tile of rows through all H steps (mean: a cluster of CTAs per tile, one ensemble member each;
ts1 and ts_inf: one CTA) and writes the visited states ``[H, rows, S]``;
:func:`make_rollout_kernel_evaluator` then applies the user's torch ``reward_fn`` to all
transitions at once, sums the discounted returns and applies the NaN guard.

ts_inf (PETS' TS-infinity, beyond the JAX kernels) is ts1 on a probabilistic head: each step of
a row takes a Gaussian sample of its member's head with the row's standard normals of that
step, an input ``noise [H, rows, S]`` that the caller draws (the policy draws the eager path's
noise, from the same generator), in float32.

What bounds it on the H100: a CTA streams one member's weights from L2 at every step and
feeds each element to the tile's rows; float32 is then bound by the SM's FMA issue, bfloat16
(tensor cores) by that stream. The design and its trade-offs are in the CUDA sources' notes.

:func:`rollout_states` is the wrapper: on a CPU tensor it runs :func:`rollout_states_plain`;
on a CUDA tensor it launches the kernel or raises, and adds one to ``rollout_states.launches``
where it launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.dynamics import (
    _MAX_LOGVAR, _MIN_LOGVAR, DynamicsParams, LearnedDynamicsConfig, logvar_bounds, net_layers,
    ts_member_ids,
)
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.rollout.evaluator import NAN_REWARD
from blackbox_mpc_torch.utils.profiling import span

__all__ = [
    "OCCUPANCY_FIELDS", "TILE_MEAN", "TILE_TS1", "TILE_TS_INF", "KernelOperands",
    "check_operands", "check_tensor", "fragment_pack", "int_array", "kernel_occupancy",
    "make_operands", "make_rollout_kernel_evaluator", "occupancy_report", "operand_cache",
    "padded_widths", "rollout_states", "rollout_states_plain", "tile_rows",
]

# Rows per tile, one per propagation (kTileMean, kTileTs1, kTileTsInf in ops/csrc/mlp_step.cuh; the
# kernels' entry points refuse another). Measured at the flagship (1000 rows, H=50, E=5, 3x500,
# f32) on an H100 80GB HBM3 at 700 W by `ops/measure.py sweep`, K2's ms per launch:
# mean 24: 11.07 (42 clusters of 5 CTAs, 2 CTAs per SM), 32: 13.28 and 40: 17.42 (32 and 25
# clusters where the card holds 22 at once: two waves), 48: 8.95 (21 clusters, one wave; the
# largest tile whose two f32 activation buffers fit 227 KB). ts1 4: 3.36, 8: 3.04, 16: 4.90
# (65 CTAs for 132 SMs), 32: 6.46. The fused CEM's logical ts1 tile must be a multiple of
# TILE_TS1. TILE_TS_INF at PETS' shape (10 000 particle rows, H=30, 5 x 4 x 200 swish with
# Gaussian heads, f32; the same card, `ops/measure.py sweep --ts-inf ... --only ts_inf`): 16:
# 4.19 (2 CTAs per SM, 3 waves, 8 bytes spilled), 20: 4.92, 24: 4.22 (16 bytes spilled), 32:
# 5.62 (3 waves), 40: 3.90 (250 CTAs of 512 threads, 2 waves, no spill), 48: 4.84.
TILE_MEAN = 48
TILE_TS1 = 8
TILE_TS_INF = 40


def tile_rows(ts1: bool, ts_inf: bool = False) -> int:
    """Rows per tile of the rollout kernels: ``TILE_TS_INF`` for ts_inf, ``TILE_TS1`` where
    each tile runs one member, else ``TILE_MEAN``."""
    if ts_inf:
        return TILE_TS_INF
    return TILE_TS1 if ts1 else TILE_MEAN


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """The kernel's inputs derived from one ``DynamicsParams``.

    ``weights`` is the per-layer ``[w, b, ...]`` list of :func:`kc.weight_operands` (used by
    the plain version); ``packed_w``/``packed_b`` are the same, zero-padded and laid back to
    back, as the CUDA kernel reads them: float32 weights as ``[E, K, N]`` blocks at widths that
    are multiples of 4, bfloat16 weights through :func:`fragment_pack`, biases ``[E, N]``.
    A probabilistic head's ``lv_bounds`` ``[2, S]`` float32 are its log-variance bounds (lower,
    upper: the learned ones, else the fixed ones).
    """

    stats: torch.Tensor  # [6, max(S, U)] float32
    weights: list
    packed_w: torch.Tensor
    packed_b: torch.Tensor
    widths: tuple  # padded layer widths, input first
    lv_bounds: torch.Tensor | None = None


def padded_widths(config: LearnedDynamicsConfig) -> tuple:
    """Layer widths, input first, rounded up to multiples of 4 (16-byte weight loads)."""
    sizes = [config.dim_s + config.dim_u, *config.hidden, config.mlp.out_dim]
    return tuple(kc.round_up(n, 4) for n in sizes)


def fragment_pack(w: torch.Tensor) -> torch.Tensor:
    """``w [E, K, N]`` -> flat ``[E, N16/16, K16/16, 32, 8]``, K and N zero-padded to 16: the A
    fragments of ``mma.sync.m16n8k16`` for ``W^T`` (m = n, the output feature), tile by tile.

    Lane ``g*4 + t`` of tile ``(mt, kt)`` holds, in register order, ``W[k, n]`` at
    ``n = 16*mt + g + 8*mh`` and ``k = 16*kt + 2*t + 8*kh + j`` for ``(kh, mh, j)`` running
    over ``{0, 1}`` each, ``j`` fastest: one 16-byte load per lane is a whole fragment."""
    e, k, n = w.shape
    kp, np_ = kc.round_up(k, 16), kc.round_up(n, 16)
    w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    w = w.reshape(e, kp // 16, 2, 4, 2, np_ // 16, 2, 8)  # [E, kt, kh, t, j, mt, mh, g]
    return w.permute(0, 5, 1, 7, 3, 2, 6, 4).reshape(-1)  # [E, mt, kt, g, t, kh, mh, j]


def _packed_elements(widths: tuple, bf16: bool) -> int:
    """Elements of one member's packed weights."""
    pad = (lambda v: kc.round_up(v, 16)) if bf16 else (lambda v: v)
    return sum(pad(k) * pad(n) for k, n in zip(widths[:-1], widths[1:]))


def make_operands(dp: DynamicsParams, config: LearnedDynamicsConfig) -> KernelOperands:
    """Packs ``dp`` for the kernels; ``make_operands.calls`` counts the packs (a caller that
    plans on new weights packs them once)."""
    make_operands.calls += 1
    weights = kc.weight_operands(dp, config.compute_dtype)
    widths = padded_widths(config)
    bf16 = config.compute_dtype == torch.bfloat16
    packed_w, packed_b = [], []
    for layer, (w, b) in enumerate(zip(weights[0::2], weights[1::2])):
        k, n = widths[layer], widths[layer + 1]
        padded = torch.nn.functional.pad(w, (0, n - w.shape[2], 0, k - w.shape[1]))
        packed_w.append(fragment_pack(padded) if bf16 else padded.reshape(-1))
        packed_b.append(torch.nn.functional.pad(b, (0, n - b.shape[1])).reshape(-1))
    lv_bounds = None
    if config.probabilistic:
        lo, hi = logvar_bounds(dp.params)
        device = dp.stats.mean_states.device
        fixed = lambda v: torch.full((config.dim_s,), v, device=device)  # noqa: E731
        lv_bounds = torch.stack([fixed(_MIN_LOGVAR) if lo is None else lo.float(),
                                 fixed(_MAX_LOGVAR) if hi is None else hi.float()])
    return KernelOperands(
        stats=kc.stats_matrix(dp, config.dim_s, config.dim_u),
        weights=weights,
        packed_w=torch.cat(packed_w).contiguous(),
        packed_b=torch.cat(packed_b).contiguous(),
        widths=widths,
        lv_bounds=lv_bounds,
    )


make_operands.calls = 0


def rollout_states_plain(
    config: LearnedDynamicsConfig, ops: KernelOperands, actions: torch.Tensor,
    s0: torch.Tensor, tile_member: torch.Tensor | None, noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same ``[H, rows, S]`` output.

    ``tile_member`` (ts1, ts_inf) names each tile's member; the rows are member-major with
    every member's block a whole number of tiles, so they regroup as ``[E, rows / E, ...]``.
    ``noise`` ``[H, rows, S]`` (ts_inf) samples the Gaussian head at every step.
    """
    horizon, rows, _ = actions.shape
    grouped = tile_member is not None
    step = kc.build_step_fn(config, ops.stats, ops.weights, grouped=grouped,
                            lv_bounds=ops.lv_bounds)
    s = s0
    if grouped:
        ensemble = config.ensemble_size
        members = torch.repeat_interleave(tile_member.long(), tile_rows(True, noise is not None))
        expected = torch.arange(ensemble, device=members.device).repeat_interleave(rows // ensemble)
        if rows % ensemble or not torch.equal(members, expected):
            raise ValueError("member-tile rows must be member-major blocks of equal size")
        s = s0.reshape(ensemble, rows // ensemble, -1)
    out = []
    for t in range(horizon):
        a = actions[t].reshape(s.shape[:-1] + (-1,))
        s = step(s, a, None if noise is None else noise[t].reshape(s.shape))
        out.append(s.reshape(rows, -1))
    return torch.stack(out)


def _lib():
    from blackbox_mpc_torch.ops._build import load_library

    lib = load_library("rollout")
    if not getattr(lib, "_bbmpc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bbmpc_rollout_states.argtypes = [p] * 9 + [i] * 7 + [p] + [i] * 5 + [p]
        lib.bbmpc_rollout_states.restype = i
        lib.bbmpc_rollout_occupancy.argtypes = [i, i, i, i, p, i, i, i, i, p]
        lib.bbmpc_rollout_occupancy.restype = i
        lib._bbmpc_typed = True
    return lib


def int_array(values):
    return (ctypes.c_int * len(values))(*values)


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_operands(config: LearnedDynamicsConfig, ops: KernelOperands, device) -> tuple:
    """Raises unless ``ops`` are the kernel operands of ``config`` on ``device``; returns the
    padded widths."""
    check_tensor(ops.stats, "stats", torch.float32, (6, max(config.dim_s, config.dim_u)), device)
    widths = padded_widths(config)
    if tuple(ops.widths) != widths:
        raise ValueError(f"operands have widths {ops.widths}, config needs {widths}")
    ensemble = config.ensemble_size
    bf16 = config.compute_dtype == torch.bfloat16
    check_tensor(ops.packed_w, "packed_w", config.compute_dtype,
                 (ensemble * _packed_elements(widths, bf16),), device)
    check_tensor(ops.packed_b, "packed_b", torch.float32, (ensemble * sum(widths[1:]),), device)
    if config.probabilistic:
        check_tensor(ops.lv_bounds, "lv_bounds", torch.float32, (2, config.dim_s), device)
    return widths


def rollout_states(
    config: LearnedDynamicsConfig, ops: KernelOperands, actions: torch.Tensor,
    s0: torch.Tensor, tile_member: torch.Tensor | None, noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's wrapper: ``actions [H, rows, U]``, ``s0 [rows, S]`` -> ``[H, rows, S]``.

    ``rows`` is a multiple of the tile: ``TILE_TS1`` with ``tile_member [rows / TILE_TS1]``
    (ts1); ``TILE_TS_INF`` with ``tile_member`` and the standard normals ``noise [H, rows,
    S]`` (ts_inf, which ``noise`` must come with and only with); else ``TILE_MEAN``. CPU
    tensors take :func:`rollout_states_plain`. CUDA tensors launch the kernel on the current
    stream or raise (a shape whose tile does not fit the CTA's shared memory, a cluster the
    card refuses); there is no fallback.
    """
    with span("kernels.K2"):
        sampled = config.propagation == "ts_inf"
        if (noise is not None) != sampled or (sampled and tile_member is None):
            raise ValueError("ts_inf takes noise and tile_member; other propagations no noise")
        if actions.device.type == "cpu":
            return rollout_states_plain(config, ops, actions, s0, tile_member, noise)
        if actions.device.type != "cuda":
            raise ValueError(f"rollout kernel runs on cuda or cpu tensors, not {actions.device}")
        kc.check_kernel_support(config, "rollout kernel", rollout=True)
        device = actions.device
        horizon, rows, dim_u = actions.shape
        dim_s = config.dim_s
        tile = tile_rows(tile_member is not None, sampled)
        if rows % tile or dim_u != config.dim_u:
            raise ValueError(
                f"rows ({rows}) must be a multiple of tile ({tile}) and U={config.dim_u}")
        check_tensor(actions, "actions", torch.float32, (horizon, rows, dim_u), device)
        check_tensor(s0, "s0", torch.float32, (rows, dim_s), device)
        widths = check_operands(config, ops, device)
        ensemble = config.ensemble_size
        if tile_member is not None:
            check_tensor(tile_member, "tile_member", torch.int32, (rows // tile,), device)
        if sampled:
            check_tensor(noise, "noise", torch.float32, (horizon, rows, dim_s), device)
        out = torch.empty((horizon, rows, dim_s), dtype=torch.float32, device=device)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _lib().bbmpc_rollout_states(
                actions.data_ptr(), s0.data_ptr(), ops.stats.data_ptr(), ops.packed_w.data_ptr(),
                ops.packed_b.data_ptr(), ptr(tile_member), ptr(noise),
                ptr(ops.lv_bounds) if sampled else None,
                out.data_ptr(), horizon, rows, dim_s, dim_u, ops.stats.shape[1],
                ensemble, len(widths) - 1, int_array(widths),
                kc.KERNEL_ACTIVATIONS[config.activation], int(config.normalized),
                int(config.predict_delta), int(config.compute_dtype == torch.bfloat16), tile,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"rollout kernel launch failed: CUDA error {err}")
        rollout_states.launches += 1
        return out


rollout_states.launches = 0


OCCUPANCY_FIELDS = ("smem_bytes", "blocks_per_sm", "cluster", "max_active_clusters",
                    "registers", "local_bytes", "threads")


def occupancy_report(values, rows: int, tile: int) -> dict:
    """The kernels' occupancy array as a dict, with the tile, the clusters the grid has and
    the waves it needs (``max_active_clusters`` is ``cudaOccupancyMaxActiveClusters``)."""
    out = dict(zip(OCCUPANCY_FIELDS, values), tile=tile)
    out["grid_clusters"] = rows // tile
    out["waves"] = -(-out["grid_clusters"] // max(out["max_active_clusters"], 1))
    return out


def kernel_occupancy(config: LearnedDynamicsConfig, rows: int) -> dict:
    """What one launch of the kernel on ``rows`` rows (a multiple of the tile) occupies at
    ``config``: shared memory per CTA, resident CTAs per SM, CTAs per cluster, the clusters the
    card holds at once, the clusters and waves of the grid, registers and local bytes."""
    widths = padded_widths(config)
    ts1 = config.ensemble_size > 1 and config.propagation == "ts1"
    ts_inf = config.propagation == "ts_inf"
    tile = tile_rows(ts1, ts_inf)
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    err = _lib().bbmpc_rollout_occupancy(
        rows, config.dim_s, config.ensemble_size, len(widths) - 1, int_array(widths),
        int(config.compute_dtype == torch.bfloat16), int(ts1), int(ts_inf), tile, out,
    )
    if err != 0:
        raise RuntimeError(f"rollout kernel occupancy query failed: CUDA error {err}")
    return occupancy_report(list(out), rows, tile)


def _versions(dp: DynamicsParams) -> tuple:
    tensors = [t for layer in net_layers(dp.params) for t in layer.values()]
    tensors += [t for t in logvar_bounds(dp.params) if t is not None]
    tensors += [getattr(dp.stats, f) for f in STATS_FIELDS]
    return tuple(t._version for t in tensors)


def operand_cache(config: LearnedDynamicsConfig) -> Callable[[DynamicsParams], KernelOperands]:
    """``operands(dp)``: :func:`make_operands` of the last ``dp``, packed anew only when ``dp``
    is another object or a tensor of it was changed in place (optimizer.step, copy_), which
    its version counters show."""
    cache = {}

    def operands(dp: DynamicsParams) -> KernelOperands:
        versions = _versions(dp)
        if cache.get("dp") is not dp or cache["versions"] != versions:
            cache["dp"], cache["versions"], cache["ops"] = dp, versions, make_operands(dp, config)
        return cache["ops"]

    return operands


def make_rollout_kernel_evaluator(
    config: LearnedDynamicsConfig,
    reward_fn: Callable,
    *,
    discount: float = 1.0,
    nan_guard: bool = True,
    device=None,
):
    """Builds ``evaluate(dp, initial_states [A,S], actions [P,A,H,U], noise=None) -> rewards
    [P,A]``.

    The counterpart of ``make_pallas_rollout_evaluator``: the initial states are tiled
    agent-minor, ragged rows are padded to whole tiles, and for ts1 the rows are permuted
    member-major with every member's block padded to whole tiles and the returns gathered
    back (``pallas_rollout.py:133-166,219-223``). The discount is the repeated float32
    multiply of the JAX kernels.

    ts_inf, as the eager evaluator of ``rollout/evaluator.py`` with ``num_particles``: each
    candidate is rolled out ``K = config.num_particles`` times, particle ``j`` of candidate
    ``i`` on rows ``(i*K + j)*A + a``, row by row with ``noise`` ``[H, P*K*A, S]`` (which
    ts_inf needs and no other propagation takes) and the members of ts1, and the K returns
    are averaged before the NaN guard.
    """
    kc.check_kernel_support(config, "rollout kernel", rollout=True)
    device = resolve_device(device)
    ensemble = config.ensemble_size
    sampled = config.propagation == "ts_inf"
    grouped = sampled or (ensemble > 1 and config.propagation == "ts1")  # a member per tile
    tile = tile_rows(grouped, sampled)
    particles = config.num_particles if sampled else 1
    operands = operand_cache(config)

    @functools.lru_cache(maxsize=8)
    def discounts(horizon: int) -> torch.Tensor:
        # discount^t by repeated float32 multiplication, as the JAX kernels carry it.
        disc = np.ones(horizon, np.float32)
        for i in range(1, horizon):
            disc[i] = disc[i - 1] * np.float32(discount)
        return torch.as_tensor(disc, device=device)

    @functools.lru_cache(maxsize=8)
    def member_tiles(rows: int) -> tuple:
        """``(src, dest, tile_member)`` on the device: the rows of ``ts_member_ids(rows, E)``
        member-major (a stable argsort), each member's block of ``rows / E`` padded to whole
        tiles with its first row; ``src`` [E * block] is the row each laid-out row reads,
        ``dest`` [rows] where each row's return lies, ``tile_member`` each tile's member."""
        per = rows // ensemble
        block = kc.round_up(per, tile)
        perm = np.argsort(ts_member_ids(rows, ensemble), kind="stable").reshape(ensemble, per)
        src = np.concatenate([perm, np.repeat(perm[:, :1], block - per, axis=1)], axis=1)
        dest = np.empty(rows, np.int64)
        dest[perm.reshape(-1)] = (np.arange(ensemble)[:, None] * block
                                  + np.arange(per)[None, :]).reshape(-1)
        members = np.repeat(np.arange(ensemble, dtype=np.int32), block // tile)
        return tuple(torch.as_tensor(x, device=device) for x in (src.reshape(-1), dest, members))

    def evaluate(dp: DynamicsParams, initial_states: torch.Tensor,
                 action_sequences: torch.Tensor, noise: torch.Tensor | None = None):
        if action_sequences.device != device or initial_states.device != device:
            raise ValueError(f"inputs must be on {device}")
        pop, agents, horizon, dim_u = action_sequences.shape
        if dim_u != config.dim_u:
            raise ValueError(f"action dim {dim_u} != config.dim_u {config.dim_u}")
        rows = pop * particles * agents
        if (noise is not None) != sampled:
            raise ValueError("noise [H, P*K*A, S] is taken by propagation='ts_inf', and only "
                             f"by it; got {config.propagation!r} with noise="
                             f"{None if noise is None else list(noise.shape)}")
        if sampled and tuple(noise.shape) != (horizon, rows, config.dim_s):
            raise ValueError(f"noise must be [H, P*K*A, S] = [{horizon}, {rows}, "
                             f"{config.dim_s}], got {list(noise.shape)}")
        flat = action_sequences.float()
        if particles > 1:
            flat = flat.repeat_interleave(particles, dim=0)  # [P*K, A, H, U]
        flat = flat.reshape(rows, horizon, dim_u)
        s0 = initial_states.float().repeat(pop * particles, 1)  # agent-minor, as jnp.tile
        tile_member = None
        if grouped:
            if rows % ensemble:
                raise ValueError(f"{config.propagation} needs pop*particles*agents ({rows}) "
                                 f"divisible by ensemble ({ensemble})")
            src, dest, tile_member = member_tiles(rows)
            flat, s0 = flat[src], s0[src]
            if sampled:
                noise = noise.float()[:, src]
        else:
            padded_rows = kc.round_up(rows, tile)
            if padded_rows != rows:
                flat = torch.nn.functional.pad(flat, (0, 0, 0, 0, 0, padded_rows - rows))
                s0 = torch.nn.functional.pad(s0, (0, 0, 0, padded_rows - rows))
        acts = flat.transpose(0, 1).contiguous()  # time-major [H, rows_pad, U]
        s0 = s0.contiguous()
        launch = (config, operands(dp), acts, s0, tile_member)
        states = rollout_states(*launch, noise) if sampled else rollout_states(*launch)
        prev = torch.cat([s0[None], states[:-1]])
        rows_pad = s0.shape[0]
        r = reward_fn(
            prev.reshape(horizon * rows_pad, -1), acts.reshape(horizon * rows_pad, -1),
            states.reshape(horizon * rows_pad, -1),
        ).reshape(horizon, rows_pad)
        total = (r * discounts(horizon)[:, None]).sum(0)
        total = total[dest] if grouped else total[:rows]
        if particles > 1:
            rewards = total.reshape(pop, particles, agents).mean(1)
        else:
            rewards = total.reshape(pop, agents)
        if nan_guard:
            rewards = torch.where(torch.isnan(rewards), NAN_REWARD, rewards)
        return rewards

    return evaluate
