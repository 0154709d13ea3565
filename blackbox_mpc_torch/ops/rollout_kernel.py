"""K2: the fused ensemble-MLP rollout as a hand-written CUDA kernel, with its plain version.

Replaces ``blackbox_mpc_tpu/ops/pallas_rollout.py::make_pallas_rollout_evaluator`` and, inside
it, ``ops/_kernel_common.py::build_step_fn``. The kernel (``ops/csrc/rollout.cu``) rolls a
tile of rows through all H steps (mean: a cluster of CTAs per tile, one ensemble member each;
ts1: one CTA) and writes the visited states ``[H, rows, S]``;
:func:`make_rollout_kernel_evaluator` then applies the user's torch ``reward_fn`` to all
transitions at once, sums the discounted returns and applies the NaN guard.

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
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig, ts_member_ids
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.rollout.evaluator import NAN_REWARD
from blackbox_mpc_torch.utils.profiling import span

__all__ = [
    "OCCUPANCY_FIELDS", "TILE_MEAN", "TILE_TS1", "KernelOperands", "check_operands",
    "check_tensor", "fragment_pack", "int_array", "kernel_occupancy", "make_operands",
    "make_rollout_kernel_evaluator", "occupancy_report", "operand_cache", "padded_widths",
    "rollout_states", "rollout_states_plain", "tile_rows",
]

# Rows per tile, one per propagation (kTileMean and kTileTs1 in ops/csrc/mlp_step.cuh; the
# kernels' entry points refuse another). Measured at the flagship (1000 rows, H=50, E=5, 3x500,
# f32) on an H100 80GB HBM3 at 700 W by `ops/measure.py sweep`, K2's ms per launch:
# mean 24: 11.07 (42 clusters of 5 CTAs, 2 CTAs per SM), 32: 13.28 and 40: 17.42 (32 and 25
# clusters where the card holds 22 at once: two waves), 48: 8.95 (21 clusters, one wave; the
# largest tile whose two f32 activation buffers fit 227 KB). ts1 4: 3.36, 8: 3.04, 16: 4.90
# (65 CTAs for 132 SMs), 32: 6.46. The fused CEM's logical ts1 tile must be a multiple of
# TILE_TS1.
TILE_MEAN = 48
TILE_TS1 = 8


def tile_rows(ts1: bool) -> int:
    """Rows per tile of the rollout kernels: ``TILE_TS1`` where each tile runs one member,
    else ``TILE_MEAN``."""
    return TILE_TS1 if ts1 else TILE_MEAN


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """The kernel's inputs derived from one ``DynamicsParams``.

    ``weights`` is the per-layer ``[w, b, ...]`` list of :func:`kc.weight_operands` (used by
    the plain version); ``packed_w``/``packed_b`` are the same, zero-padded and laid back to
    back, as the CUDA kernel reads them: float32 weights as ``[E, K, N]`` blocks at widths that
    are multiples of 4, bfloat16 weights through :func:`fragment_pack`, biases ``[E, N]``.
    """

    stats: torch.Tensor  # [6, max(S, U)] float32
    weights: list
    packed_w: torch.Tensor
    packed_b: torch.Tensor
    widths: tuple  # padded layer widths, input first


def padded_widths(config: LearnedDynamicsConfig) -> tuple:
    """Layer widths, input first, rounded up to multiples of 4 (16-byte weight loads)."""
    sizes = [config.dim_s + config.dim_u, *config.hidden, config.dim_s]
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
    return KernelOperands(
        stats=kc.stats_matrix(dp, config.dim_s, config.dim_u),
        weights=weights,
        packed_w=torch.cat(packed_w).contiguous(),
        packed_b=torch.cat(packed_b).contiguous(),
        widths=widths,
    )


make_operands.calls = 0


def rollout_states_plain(
    config: LearnedDynamicsConfig, ops: KernelOperands, actions: torch.Tensor,
    s0: torch.Tensor, tile_member: torch.Tensor | None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same ``[H, rows, S]`` output.

    ``tile_member`` (ts1) names each tile's member; the rows are member-major with every
    member's block a whole number of tiles, so they regroup as ``[E, rows / E, ...]``.
    """
    horizon, rows, _ = actions.shape
    grouped = tile_member is not None
    step = kc.build_step_fn(config, ops.stats, ops.weights, grouped=grouped)
    s = s0
    if grouped:
        ensemble = config.ensemble_size
        members = torch.repeat_interleave(tile_member.long(), TILE_TS1)
        expected = torch.arange(ensemble, device=members.device).repeat_interleave(rows // ensemble)
        if rows % ensemble or not torch.equal(members, expected):
            raise ValueError("ts1 rows must be member-major blocks of equal size")
        s = s0.reshape(ensemble, rows // ensemble, -1)
    out = []
    for t in range(horizon):
        a = actions[t].reshape(s.shape[:-1] + (-1,))
        s = step(s, a)
        out.append(s.reshape(rows, -1))
    return torch.stack(out)


def _lib():
    from blackbox_mpc_torch.ops._build import load_library

    lib = load_library("rollout")
    if not getattr(lib, "_bbmpc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bbmpc_rollout_states.argtypes = [p] * 7 + [i] * 7 + [p] + [i] * 5 + [p]
        lib.bbmpc_rollout_states.restype = i
        lib.bbmpc_rollout_occupancy.argtypes = [i, i, i, i, p, i, i, i, p]
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
    return widths


def rollout_states(
    config: LearnedDynamicsConfig, ops: KernelOperands, actions: torch.Tensor,
    s0: torch.Tensor, tile_member: torch.Tensor | None,
) -> torch.Tensor:
    """The kernel's wrapper: ``actions [H, rows, U]``, ``s0 [rows, S]`` -> ``[H, rows, S]``.

    ``rows`` is a multiple of the tile: ``TILE_TS1`` with ``tile_member [rows / TILE_TS1]``
    (ts1), else ``TILE_MEAN``. CPU tensors take :func:`rollout_states_plain`. CUDA tensors
    launch the kernel on the current stream or raise (a shape whose tile does not fit the
    CTA's shared memory, a cluster the card refuses); there is no fallback.
    """
    with span("kernels.K2"):
        if actions.device.type == "cpu":
            return rollout_states_plain(config, ops, actions, s0, tile_member)
        if actions.device.type != "cuda":
            raise ValueError(f"rollout kernel runs on cuda or cpu tensors, not {actions.device}")
        kc.check_kernel_support(config, "rollout kernel")
        device = actions.device
        horizon, rows, dim_u = actions.shape
        dim_s = config.dim_s
        tile = tile_rows(tile_member is not None)
        if rows % tile or dim_u != config.dim_u:
            raise ValueError(
                f"rows ({rows}) must be a multiple of tile ({tile}) and U={config.dim_u}")
        check_tensor(actions, "actions", torch.float32, (horizon, rows, dim_u), device)
        check_tensor(s0, "s0", torch.float32, (rows, dim_s), device)
        widths = check_operands(config, ops, device)
        ensemble = config.ensemble_size
        if tile_member is not None:
            check_tensor(tile_member, "tile_member", torch.int32, (rows // tile,), device)
        out = torch.empty((horizon, rows, dim_s), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _lib().bbmpc_rollout_states(
                actions.data_ptr(), s0.data_ptr(), ops.stats.data_ptr(), ops.packed_w.data_ptr(),
                ops.packed_b.data_ptr(), None if tile_member is None else tile_member.data_ptr(),
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
    tile = tile_rows(ts1)
    out = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    err = _lib().bbmpc_rollout_occupancy(
        rows, config.dim_s, config.ensemble_size, len(widths) - 1, int_array(widths),
        int(config.compute_dtype == torch.bfloat16), int(ts1), tile, out,
    )
    if err != 0:
        raise RuntimeError(f"rollout kernel occupancy query failed: CUDA error {err}")
    return occupancy_report(list(out), rows, tile)


def _versions(dp: DynamicsParams) -> tuple:
    tensors = [t for layer in dp.params for t in layer.values()]
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
    """Builds ``evaluate(dp, initial_states [A,S], actions [P,A,H,U]) -> rewards [P,A]``.

    The counterpart of ``make_pallas_rollout_evaluator``: the initial states are tiled
    agent-minor, ragged rows are padded to whole tiles, and for ts1 the rows are permuted
    member-major with every member's block padded to whole tiles and the rewards scattered
    back (``pallas_rollout.py:133-166,219-223``). The discount is the repeated float32
    multiply of the JAX kernels.
    """
    kc.check_kernel_support(config, "rollout kernel")
    device = resolve_device(device)
    ensemble = config.ensemble_size
    ts1 = ensemble > 1 and config.propagation == "ts1"
    tile = tile_rows(ts1)
    operands = operand_cache(config)

    @functools.lru_cache(maxsize=8)
    def discounts(horizon: int) -> torch.Tensor:
        # discount^t by repeated float32 multiplication, as the JAX kernels carry it.
        disc = np.ones(horizon, np.float32)
        for i in range(1, horizon):
            disc[i] = disc[i - 1] * np.float32(discount)
        return torch.as_tensor(disc, device=device)

    @functools.lru_cache(maxsize=8)
    def member_major(rows: int) -> torch.Tensor:
        # Stable argsort of the ts1 member ids groups rows member-major in equal blocks.
        perm = np.argsort(ts_member_ids(rows, ensemble), kind="stable")
        return torch.as_tensor(perm, device=device)

    def evaluate(dp: DynamicsParams, initial_states: torch.Tensor, action_sequences: torch.Tensor):
        if action_sequences.device != device or initial_states.device != device:
            raise ValueError(f"inputs must be on {device}")
        pop, agents, horizon, dim_u = action_sequences.shape
        if dim_u != config.dim_u:
            raise ValueError(f"action dim {dim_u} != config.dim_u {config.dim_u}")
        rows = pop * agents
        flat = action_sequences.reshape(rows, horizon, dim_u).float()
        s0 = initial_states.float().repeat(pop, 1)  # agent-minor, as jnp.tile(s, (pop, 1))
        tile_member = None
        if ts1:
            if rows % ensemble:
                raise ValueError(
                    f"ts1 needs pop*agents ({rows}) divisible by ensemble ({ensemble})"
                )
            per_member = rows // ensemble
            perm = member_major(rows)
            block = kc.round_up(per_member, tile)
            tile_member = torch.arange(ensemble, dtype=torch.int32, device=device)
            tile_member = tile_member.repeat_interleave(block // tile)

            def pad_blocks(x):
                grouped = x.reshape(ensemble, per_member, -1)
                padded = torch.nn.functional.pad(grouped, (0, 0, 0, block - per_member))
                return padded.reshape(ensemble * block, *x.shape[1:])

            flat = pad_blocks(flat[perm].reshape(rows, -1)).reshape(-1, horizon, dim_u)
            s0 = pad_blocks(s0[perm])
        else:
            padded_rows = kc.round_up(rows, tile)
            if padded_rows != rows:
                flat = torch.nn.functional.pad(flat, (0, 0, 0, 0, 0, padded_rows - rows))
                s0 = torch.nn.functional.pad(s0, (0, 0, 0, padded_rows - rows))
        acts = flat.transpose(0, 1).contiguous()  # time-major [H, rows_pad, U]
        s0 = s0.contiguous()
        states = rollout_states(config, operands(dp), acts, s0, tile_member)
        prev = torch.cat([s0[None], states[:-1]])
        rows_pad = s0.shape[0]
        r = reward_fn(
            prev.reshape(horizon * rows_pad, -1), acts.reshape(horizon * rows_pad, -1),
            states.reshape(horizon * rows_pad, -1),
        ).reshape(horizon, rows_pad)
        total = (r * discounts(horizon)[:, None]).sum(0)
        if ts1:
            grouped = total.reshape(ensemble, block)[:, :per_member].reshape(-1)
            rewards = torch.empty(rows, dtype=torch.float32, device=device)
            rewards[perm] = grouped
        else:
            rewards = total[:rows]
        rewards = rewards.reshape(pop, agents)
        if nan_guard:
            rewards = torch.where(torch.isnan(rewards), NAN_REWARD, rewards)
        return rewards

    return evaluate
