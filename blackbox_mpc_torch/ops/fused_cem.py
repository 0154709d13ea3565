"""K3-K6: the generate-in-kernel solver family as hand-written CUDA kernels, with their plain
versions and the solvers over them.

Counterpart of ``blackbox_mpc_tpu/ops/pallas_cem.py``. The candidate tensor ``[P, A, H, U]`` is
never stored: K4 draws each row's actions from a counter-based RNG and rolls them out, and K6
regenerates the same draws to reduce the weighted moments.

* K3, the counter RNG (``_mix``, ``_uniform``, ``_normal``, ``_gen_z``, ``_tile_counter``,
  ``_mirror_z``, ``_colored_basis2``): here in torch, in int64 masked to 32 bits, the same
  integers as the JAX package's uint32 stream bit for bit; in ``ops/csrc/fused_cem.cu`` as
  device functions. Three samplings: white clipped normal, iCEM colored noise (normals pushed
  through a spectral basis, unit std per row, clipped) and uniform in (-1, 1). On its own,
  :func:`draw_rows` draws a list of rows (the JAX package's ``_mirror_z``), with K4's bits.
* K4 :func:`fused_rollout` and K5 :func:`fused_rollout_streamed` (``kernel_a``,
  ``kernel_a_streamed``): sample + roll out, returning the visited states and the actions
  rolled out, time-major. The caller applies its torch ``reward_fn`` to them (a CUDA library
  cannot call it), as ``ops/rollout_kernel.py`` does for K2. K4 takes :class:`Features`: the
  sampling, a bounds clip with its squared-violation penalty, injected candidates in the last
  population slots, and the MPPI dot ``<gvec, centered>``.
* K6 :func:`elite_moments` (``kernel_b``): regenerate + weighted centered moments, with the
  same :class:`Features` (centered after the clip; injected rows contribute ``extra - mean``);
  the kernel draws only the rows whose weight is not 0.

Each wrapper takes its plain version for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises, and adds one to its ``launches`` where it launches. What bounds each kernel
on the H100 is in the CUDA source's note. :func:`make_fused_cem_kernels` and the solvers
:func:`make_fused_cem` (with the iCEM options), :func:`make_fused_pi2` (PI2 and MPPI),
:func:`make_fused_random_search` and :func:`make_fused_sep_cma` keep the JAX package's
signatures and semantics, without its ``interpret`` flag: the device of the tensors picks the
route. ``dp`` is the ``DynamicsParams`` or a function returning the current ones.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from blackbox_mpc_torch.core.device import per_device
from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.rollout.evaluator import NAN_REWARD
from blackbox_mpc_torch.solvers import base
from blackbox_mpc_torch.solvers import cma_es as cma
from blackbox_mpc_torch.solvers.cem import CEMConfig, CEMState, check_config, iteration_populations
from blackbox_mpc_torch.solvers.cma_es import CMAESConfig, CMAESState
from blackbox_mpc_torch.solvers.pi2 import PI2Config, PI2State, softmax_weights
from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig, RandomSearchState
from blackbox_mpc_torch.utils.profiling import span

__all__ = [
    "Features", "draw_rows", "draw_seed", "elite_moments", "elite_moments_plain",
    "fused_occupancy", "fused_rollout", "fused_rollout_plain", "fused_rollout_streamed",
    "make_fused_cem", "make_fused_cem_kernels", "make_fused_pi2", "make_fused_random_search",
    "make_fused_sep_cma",
]

_M32 = 0xFFFFFFFF
_PHI = 0x9E3779B1
_SEED2_OFFSET = 0x632BE5AB  # Box-Muller's second uniform
# 2 pi rounded to float32: JAX multiplies a float32 by the weak-typed Python float, which rounds
# the constant to float32 first.
_TWO_PI = float(np.float32(2.0 * np.pi))
# E[clip(z, -2, 2)^2] for z ~ N(0, 1): the fused family samples clipped (not resampled) normals,
# so raw second moments are deflated by this factor against the N(0, 1) that the Hansen
# constants assume.
_CLIPPED_Z_SECOND_MOMENT = 0.9205369256363231
_SAMPLING_CODES = {"normal": 0, "uniform": 1}
_COLORED_CODE = 2


# ---------------------------------------------------------------- K3: the counter RNG


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``. ``c`` is split into 16-bit
    halves, so no product passes 2**48 (a plain int64 product could pass 2**63)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of uint32 values held in int64 (any int64 is taken mod 2**32)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _u32(value) -> torch.Tensor:
    return torch.as_tensor(value).to(torch.int64) & _M32


def _keyed_bits(counter: torch.Tensor, seed) -> torch.Tensor:
    """``mix(counter * 0x9E3779B1 ^ mix(seed))`` in uint32, the integer stage of ``_uniform``."""
    key = _mix(_u32(seed))
    return _mix(_mul32(counter.to(torch.int64) & _M32, _PHI) ^ key.to(counter.device))


def _uniform(counter: torch.Tensor, seed) -> torch.Tensor:
    """Uniform in (0, 1) from int element counters and a seed: top 24 bits -> (x + 0.5) / 2**24."""
    top24 = _keyed_bits(counter, seed) >> 8
    return (top24.to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def _normal(counter: torch.Tensor, seed) -> torch.Tensor:
    """N(0, 1) by Box-Muller (unclipped); the second uniform's seed is ``seed + 0x632BE5AB``
    wrapped to 32 bits, as JAX's int32 add wraps."""
    u1 = _uniform(counter, seed)
    u2 = _uniform(counter, _u32(seed) + _SEED2_OFFSET)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def _colored_basis2(horizon: int, dim_u: int, beta: float) -> np.ndarray:
    """``[U*2F, H*U]`` float32 spectral-synthesis matrix reproducing
    ``solvers.base.colored_noise``: the ``[2F, H]`` basis of
    :func:`base.colored_synthesis_basis`, once per action dim (rows ``u*2F + k``, columns
    ``h*U + u``). The plain version multiplies by it; the kernels contract the block."""
    block = base.colored_synthesis_basis(horizon, beta).astype(np.float32)
    return _dense_basis(torch.as_tensor(block), dim_u).numpy()


def _basis_block(basis2: torch.Tensor, dim_u: int) -> torch.Tensor:
    """The ``[2F, H]`` block of the dense ``[U*2F, H*U]`` basis, what the kernels contract."""
    return basis2[:basis2.shape[0] // dim_u, ::dim_u].contiguous()


def _dense_basis(basis: torch.Tensor, dim_u: int) -> torch.Tensor:
    """The dense ``[U*2F, H*U]`` basis of a ``[2F, H]`` block, laid out as
    :func:`_colored_basis2` lays it out: what the plain versions multiply by."""
    two_f, horizon = basis.shape
    dense = basis.new_zeros((dim_u * two_f, horizon * dim_u))
    for u in range(dim_u):
        dense[u * two_f:(u + 1) * two_f, u::dim_u] = basis
    return dense


def _gen_z(counter: torch.Tensor, seed, basis2=None, sampling: str = "normal") -> torch.Tensor:
    """The z block of int counters, the same for the kernels' plain versions and the mirror.

    ``sampling="normal"``, white (``basis2 is None``): counter is ``[N, n_flat]`` and z is
    ``clip(normal, -2, 2)``, clipped after Box-Muller. Colored: counter is ``[N, U*2F]``; the
    normals go through ``basis2``, each row is normalized to unit std over its whole (H, U)
    sequence and clipped at +/-2. ``sampling="uniform"``: z ~ U(-1, 1).
    """
    if sampling == "uniform":
        return 2.0 * _uniform(counter, seed) - 1.0
    g = _normal(counter, seed)
    if basis2 is None:
        return torch.clamp(g, -2.0, 2.0)
    sig = g @ basis2.to(g.device)  # [N, H*U]
    mu = sig.mean(dim=1, keepdim=True)
    std = torch.sqrt(torch.clamp_min(torch.square(sig - mu).mean(dim=1, keepdim=True), 0.0))
    return torch.clamp(sig / (std + 1e-8), -2.0, 2.0)


def _tile_counter(row0: int, t_rows: int, n_cols: int, device=None) -> torch.Tensor:
    """``[T, C]`` element counters of rows ``[row0, row0 + T)``: counter = row * C + col."""
    rows = row0 + torch.arange(t_rows, dtype=torch.int64, device=device)
    return rows[:, None] * n_cols + torch.arange(n_cols, dtype=torch.int64, device=device)


def _mirror_z(seed, row_ids: torch.Tensor, n_flat: int, basis2=None,
              sampling: str = "normal") -> torch.Tensor:
    """The draws ``[N, n_flat]`` of arbitrary rows ``row_ids [N]``, from the kernels' counters
    (``row * n_cols + col``, ``n_cols = U*2F`` when colored): the plain version of
    :func:`draw_rows` and of the kernels' draws. White and uniform draws equal the kernels'
    bit for bit; colored ones differ in the last bits (another summation order)."""
    n_cols = n_flat if basis2 is None else basis2.shape[0]
    cols = torch.arange(n_cols, dtype=torch.int64, device=row_ids.device)
    return _gen_z(row_ids.to(torch.int64)[:, None] * n_cols + cols, seed, basis2, sampling)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """One seed in ``[0, 2**31 - 1)`` as an int32 ``[1]`` tensor on the generator's device (the
    JAX range, ``pallas_cem.py:735``): no host round trip."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device,
                         dtype=torch.int32)


# ---------------------------------------------------------------- the options of K4 and K6


@dataclasses.dataclass(frozen=True)
class Features:
    """The optional parts of K4 and K6 (``None`` switches one off). All tensors are float32 on
    the device of the call."""

    sampling: str = "normal"  # "normal" or "uniform"
    basis2: torch.Tensor | None = None  # colored: dense [U*2F, H*U], what the plain versions use
    basis: torch.Tensor | None = None  # colored: its block [2F, H], what the kernels contract
    extra: torch.Tensor | None = None  # [extra_slots * A, H*U] injected candidates
    population: int = 0  # with extra: population indices >= population - extra_slots read it
    clip: torch.Tensor | None = None  # [2, U]: lower, upper
    gvec: torch.Tensor | None = None  # [A, H*U], K4 only: also return <gvec, centered> per row

    def extra_slots(self, agents: int) -> int:
        return 0 if self.extra is None else self.extra.shape[0] // agents


_NO_FEATURES = Features()


def _centered_rows(features: Features, mean_rows, std_rows, z, row_ids, agents: int):
    """Per row of ``z [rows, H*U]``: ``(actions, centered, raw - clipped or None)``. centered is
    ``std * z``, the clipped action less the mean with a bounds clip, and ``extra - mean`` on
    injected rows."""
    centered = std_rows * z
    flat = mean_rows + centered
    violation = None
    if features.clip is not None:
        reps = z.shape[1] // features.clip.shape[1]  # column c has bounds c % U
        clipped = torch.clamp(flat, features.clip[0].repeat(reps), features.clip[1].repeat(reps))
        violation = flat - clipped
        flat, centered = clipped, clipped - mean_rows
    if features.extra is not None:
        slots = features.extra_slots(agents)
        fresh = features.population - slots
        p_ids = row_ids // agents
        injected = ((p_ids >= fresh) & (p_ids < features.population))[:, None]
        index = torch.clamp((p_ids - fresh) * agents + row_ids % agents, 0, slots * agents - 1)
        values = features.extra[index]
        flat = torch.where(injected, values, flat)
        centered = torch.where(injected, values - mean_rows, centered)
    return flat, centered, violation


# ---------------------------------------------------------------- K4/K5: sample + roll out


def _roll(step, s: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    out = []
    for a in actions:
        s = step(s, a)
        out.append(s)
    return torch.stack(out)


def fused_rollout_plain(
    config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor, seed, rows: int,
    tile_member: torch.Tensor | None = None, member_tile: int = rk.TILE_TS1,
    streamed: bool = False, features: Features | None = None,
):
    """Plain version of K4 (and of K5 with ``streamed=True``, which draws step h's actions at
    step h): the same inputs and the same ``(states [H, rows, S], actions [H, rows, U])``, at
    any row count; with ``features``, ``(states, actions, penalty [rows] or None, dots [rows]
    or None)``. Row r belongs to agent ``r % A``; for ts1 it runs member
    ``tile_member[r // member_tile]``."""
    agents, hu = mean.shape
    dim_u = config.dim_u
    horizon = hu // dim_u
    row_ids = torch.arange(rows, device=mean.device)
    agent = row_ids % agents
    mean_rows, std_rows = mean[agent], std[agent]
    penalty = dots = None
    if streamed:
        cols = torch.arange(dim_u, device=mean.device)
        steps = []
        for h in range(horizon):
            z = _gen_z(row_ids[:, None] * hu + h * dim_u + cols, seed)
            cut = slice(h * dim_u, (h + 1) * dim_u)
            steps.append(mean_rows[:, cut] + std_rows[:, cut] * z)
        actions = torch.stack(steps)
    else:
        f = features or _NO_FEATURES
        z = _mirror_z(seed, row_ids, hu, f.basis2, f.sampling)
        flat, centered, violation = _centered_rows(f, mean_rows, std_rows, z, row_ids, agents)
        if violation is not None:
            penalty = torch.square(violation).sum(dim=1)
        if f.gvec is not None:
            dots = (f.gvec[agent] * centered).sum(dim=1)
        actions = flat.reshape(rows, horizon, dim_u).transpose(0, 1)
    s = s0[agent]
    if tile_member is None:
        states = _roll(kc.build_step_fn(config, ops.stats, ops.weights), s, actions)
    else:
        members = tile_member.to(torch.int64)[row_ids // member_tile]
        single = dataclasses.replace(config, ensemble_size=1)
        states = torch.empty((horizon, rows, config.dim_s), dtype=torch.float32,
                             device=mean.device)
        for e in range(config.ensemble_size):
            idx = torch.nonzero(members == e)[:, 0]
            step = kc.build_step_fn(single, ops.stats, [w[e:e + 1] for w in ops.weights])
            states[:, idx] = _roll(step, s[idx], actions[:, idx])
    if features is None:
        return states, actions.contiguous()
    return states, actions.contiguous(), penalty, dots


def _lib():
    from blackbox_mpc_torch.ops._build import load_library

    lib = load_library("fused_cem")
    if not getattr(lib, "_bbmpc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        rollout_args = [p] * 5 + [i] + [p] * 5 + [i] * 8 + [p] + [i] * 5
        options = [i, i, i, p, p, i, i, p, p, p, p]
        lib.bbmpc_fused_rollout.argtypes = rollout_args + options + [p]
        lib.bbmpc_fused_rollout.restype = i
        lib.bbmpc_fused_rollout_streamed.argtypes = rollout_args + [p]
        lib.bbmpc_fused_rollout_streamed.restype = i
        lib.bbmpc_fused_occupancy.argtypes = [i] * 6 + [p] + [i] * 8 + [p]
        lib.bbmpc_fused_occupancy.restype = i
        lib.bbmpc_elite_moments.argtypes = [p] * 6 + [i] * 7 + [p, p, i, p, p]
        lib.bbmpc_elite_moments.restype = i
        lib.bbmpc_draw_rows.argtypes = [p] * 3 + [i] * 6 + [p, p]
        lib.bbmpc_draw_rows.restype = i
        lib._bbmpc_typed = True
    return lib


def _check_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")
    return t.device


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_features(f: Features, agents: int, horizon: int, dim_u: int, device) -> tuple:
    """Raises on what the kernels do not take; returns ``(sampling code, n_cols, two_f,
    extra_slots)`` of their C interface."""
    hu = horizon * dim_u
    if f.sampling not in _SAMPLING_CODES:
        raise ValueError(f"sampling must be 'normal' or 'uniform', got {f.sampling!r}")
    code, n_cols, two_f = _SAMPLING_CODES[f.sampling], hu, 0
    if f.basis is not None:
        if f.sampling != "normal":
            raise ValueError("colored noise applies to normal sampling only")
        two_f = 2 * (horizon // 2 + 1)
        code, n_cols = _COLORED_CODE, dim_u * two_f
        rk.check_tensor(f.basis, "basis", torch.float32, (two_f, horizon), device)
    slots = f.extra_slots(agents)
    if f.extra is not None:
        if slots < 1 or not slots < f.population:
            raise ValueError(f"extra holds {slots} slots of {agents} agents; population "
                             f"({f.population}) must leave >= 1 fresh candidate")
        rk.check_tensor(f.extra, "extra", torch.float32, (slots * agents, hu), device)
    if f.clip is not None:
        rk.check_tensor(f.clip, "clip", torch.float32, (2, dim_u), device)
    if f.gvec is not None:
        rk.check_tensor(f.gvec, "gvec", torch.float32, (agents, hu), device)
    return code, n_cols, two_f, slots


def _launch_rollout(
    streamed: bool, config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0, mean, std, seed,
    rows: int, tile_member, member_tile: int, features: Features | None = None,
):
    what = "fused_rollout_streamed" if streamed else "fused_rollout"
    device = _check_cuda(mean, what)
    kc.check_kernel_support(config, what)
    agents, hu = mean.shape
    dim_s, dim_u = config.dim_s, config.dim_u
    tile = rk.tile_rows(tile_member is not None)
    if hu % dim_u or rows % tile or rows < 1:
        raise ValueError(f"{what}: mean width {hu} must be H * U (U={dim_u}) and rows ({rows}) "
                         f"a positive multiple of the tile ({tile})")
    horizon = hu // dim_u
    rk.check_tensor(mean, "mean", torch.float32, (agents, hu), device)
    rk.check_tensor(std, "std", torch.float32, (agents, hu), device)
    rk.check_tensor(s0, "s0", torch.float32, (agents, dim_s), device)
    rk.check_tensor(seed, "seed", torch.int32, (1,), device)
    widths = rk.check_operands(config, ops, device)
    if tile_member is not None:
        if member_tile <= 0 or member_tile % tile:
            raise ValueError(f"member_tile ({member_tile}) must be a multiple of {tile}")
        rk.check_tensor(tile_member, "tile_member", torch.int32,
                        (-(-rows // member_tile),), device)
    f = features or _NO_FEATURES
    code, n_cols, two_f, slots = _check_features(f, agents, horizon, dim_u, device)
    states = torch.empty((horizon, rows, dim_s), dtype=torch.float32, device=device)
    actions = torch.empty((horizon, rows, dim_u), dtype=torch.float32, device=device)
    penalty = dots = None
    if f.clip is not None:
        penalty = torch.empty(rows, dtype=torch.float32, device=device)
    if f.gvec is not None:
        dots = torch.empty(rows, dtype=torch.float32, device=device)
    lib = _lib()
    args = [
        s0.data_ptr(), mean.data_ptr(), std.data_ptr(), seed.data_ptr(), _ptr(tile_member),
        member_tile, ops.stats.data_ptr(), ops.packed_w.data_ptr(), ops.packed_b.data_ptr(),
        states.data_ptr(), actions.data_ptr(), horizon, rows, agents, dim_s, dim_u,
        ops.stats.shape[1], config.ensemble_size, len(widths) - 1, rk.int_array(widths),
        kc.KERNEL_ACTIVATIONS[config.activation], int(config.normalized),
        int(config.predict_delta), int(config.compute_dtype == torch.bfloat16), tile,
    ]
    if streamed:
        entry = lib.bbmpc_fused_rollout_streamed
    else:
        entry = lib.bbmpc_fused_rollout
        args += [code, n_cols, two_f, _ptr(f.basis), _ptr(f.extra), slots, f.population,
                 _ptr(f.clip), _ptr(f.gvec), _ptr(penalty), _ptr(dots)]
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    if features is None:
        return states, actions
    return states, actions, penalty, dots


def fused_rollout(
    config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor, seed: torch.Tensor, rows: int,
    tile_member: torch.Tensor | None = None, member_tile: int = rk.TILE_TS1,
    features: Features | None = None,
):
    """K4's wrapper: ``s0 [A, S]``, ``mean``/``std [A, H*U]``, ``seed [1]`` int32 ->
    ``(states [H, rows, S], actions [H, rows, U])`` for rows ``p * A + a`` (on the card ``rows``
    is a multiple of the tile: ``rk.TILE_TS1`` with ``tile_member``, which ``member_tile`` must
    be a multiple of, else ``rk.TILE_MEAN``). With ``features`` it returns
    ``(states, actions, penalty, dots)``: the actions are the ones rolled out (clipped, or
    injected), ``penalty [rows]`` is the squared bound violation (None without ``clip``) and ``dots [rows]`` is ``<gvec, centered>``
    (None without ``gvec``). CPU tensors take :func:`fused_rollout_plain`."""
    with span("kernels.K4"):
        if mean.device.type == "cpu":
            return fused_rollout_plain(config, ops, s0, mean, std, seed, rows, tile_member,
                                       member_tile, features=features)
        out = _launch_rollout(False, config, ops, s0, mean, std, seed, rows, tile_member,
                              member_tile, features)
        fused_rollout.launches += 1
        return out


def fused_rollout_streamed(
    config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor, seed: torch.Tensor, rows: int,
    tile_member: torch.Tensor | None = None, member_tile: int = rk.TILE_TS1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's wrapper: the same function as :func:`fused_rollout` without options, by the kernel
    that draws step h's actions inside step h."""
    with span("kernels.K5"):
        if mean.device.type == "cpu":
            return fused_rollout_plain(config, ops, s0, mean, std, seed, rows, tile_member,
                                       member_tile, streamed=True)
        out = _launch_rollout(True, config, ops, s0, mean, std, seed, rows, tile_member,
                              member_tile)
        fused_rollout_streamed.launches += 1
        return out


fused_rollout.launches = 0
fused_rollout_streamed.launches = 0


def fused_occupancy(config: LearnedDynamicsConfig, rows: int, horizon: int,
                    streamed: bool = False, features: Features | None = None) -> dict:
    """What one launch of K4 (K5 with ``streamed``) on ``rows`` rows occupies at ``config``;
    the fields of :func:`rk.kernel_occupancy`. ``features`` picks K4's build with options."""
    widths = rk.padded_widths(config)
    ts1 = config.ensemble_size > 1 and config.propagation == "ts1"
    tile = rk.tile_rows(ts1)
    code, n_cols, two_f = 0, horizon * config.dim_u, 0
    if features is not None:
        code = _SAMPLING_CODES[features.sampling]
        if features.basis is not None:
            two_f = features.basis.shape[0]
            code, n_cols = _COLORED_CODE, config.dim_u * two_f
    out = (ctypes.c_int * len(rk.OCCUPANCY_FIELDS))()
    err = _lib().bbmpc_fused_occupancy(
        rows, horizon, config.dim_s, config.dim_u, config.ensemble_size, len(widths) - 1,
        rk.int_array(widths), int(config.compute_dtype == torch.bfloat16), int(ts1), tile,
        int(streamed), int(features is not None), code, n_cols, two_f, out,
    )
    if err != 0:
        raise RuntimeError(f"fused rollout occupancy query failed: CUDA error {err}")
    return rk.occupancy_report(list(out), rows, tile)


# ---------------------------------------------------------------- K6: elite moments


def elite_moments_plain(std: torch.Tensor, weights: torch.Tensor, seed, mean=None,
                        features: Features | None = None):
    """Plain version of K6: the sums over the population of ``w * centered`` and
    ``w * centered**2``, each ``[A, H*U]``, for the centered sample of row ``p * A + a``:
    ``std[a] * z(row)``, or what :class:`Features` make of it."""
    agents, hu = std.shape
    population = weights.shape[0] // agents
    f = features or _NO_FEATURES
    row_ids = torch.arange(population * agents, device=std.device)
    z = _mirror_z(seed, row_ids, hu, f.basis2, f.sampling)
    mean_rows = 0.0 if mean is None else mean.repeat(population, 1)
    _, centered, _ = _centered_rows(f, mean_rows, std.repeat(population, 1), z, row_ids, agents)
    centered = centered.reshape(population, agents, hu)
    w = weights.reshape(population, agents, 1)
    return (w * centered).sum(0), (w * (centered * centered)).sum(0)


def elite_moments(std: torch.Tensor, weights: torch.Tensor, seed: torch.Tensor,
                  mean: torch.Tensor | None = None, features: Features | None = None):
    """K6's wrapper: ``std [A, H*U]``, ``weights [P * A]`` (row ``p * A + a``; a 0/1 elite mask
    or any weights), ``seed [1]`` int32 -> ``(sum, sumsq)``, each ``[A, H*U]``. ``features``
    with a clip or injected candidates need the sampling ``mean [A, H*U]``. One launch, which
    draws only the rows whose weight is not 0. CPU tensors take :func:`elite_moments_plain`."""
    with span("kernels.K6"):
        f = features or _NO_FEATURES
        if (f.clip is not None or f.extra is not None) and mean is None:
            raise ValueError("elite_moments needs mean with a bounds clip or injected candidates")
        if std.device.type == "cpu":
            return elite_moments_plain(std, weights, seed, mean, features)
        device = _check_cuda(std, "elite_moments")
        agents, hu = std.shape
        rows = weights.numel()
        if weights.dim() != 1 or rows == 0 or rows % agents:
            raise ValueError(f"weights must be [population * {agents}], got {tuple(weights.shape)}")
        population = rows // agents
        rk.check_tensor(std, "std", torch.float32, (agents, hu), device)
        rk.check_tensor(weights, "weights", torch.float32, (rows,), device)
        rk.check_tensor(seed, "seed", torch.int32, (1,), device)
        if mean is not None:
            rk.check_tensor(mean, "mean", torch.float32, (agents, hu), device)
        # The kernel splits a column into (h, u) only for the colored draw and the clip.
        if f.basis is not None:
            horizon = f.basis.shape[1]
        elif f.clip is not None:
            horizon = hu // f.clip.shape[1]
        else:
            horizon = hu
        if horizon < 1 or hu % horizon:
            raise ValueError(f"std width {hu} is no multiple of the horizon {horizon}")
        if f.extra is not None and f.population != population:
            raise ValueError(f"features.population ({f.population}) != population ({population})")
        code, n_cols, two_f, slots = _check_features(
            dataclasses.replace(f, gvec=None), agents, horizon, hu // horizon, device)
        out = torch.empty((2, agents, hu), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _lib().bbmpc_elite_moments(
                _ptr(mean), std.data_ptr(), weights.data_ptr(), seed.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), population, agents, horizon, hu // horizon, code, n_cols, two_f,
                _ptr(f.basis), _ptr(f.extra), slots, _ptr(f.clip), stream,
            )
        if err != 0:
            raise RuntimeError(f"elite_moments kernel launch failed: CUDA error {err}")
        elite_moments.launches += 1
        return out[0], out[1]


elite_moments.launches = 0


# ---------------------------------------------------------------- K3 on its own: rows by id


def draw_rows(seed, row_ids: torch.Tensor, n_flat: int, basis: torch.Tensor | None = None,
              sampling: str = "normal") -> torch.Tensor:
    """K3's wrapper: the draws ``z [N, n_flat]`` of the rows ``row_ids [N]`` (row
    ``p * A + a``) under ``seed``, with the bits K4 drew them with: clipped normals,
    ``sampling="uniform"``, or colored through the kernels' ``[2F, H]`` basis block ``basis``.
    The solvers read candidate values with it (carried elites, the execute-best plan,
    RandomSearch's argmax) without the population. ``seed`` is an int32 ``[1]`` tensor on the
    rows' device, or an int with CPU rows. CPU tensors take :func:`_mirror_z`; CUDA ones launch
    the kernel."""
    with span("kernels.K3"):
        on_cpu = not torch.is_tensor(seed) or seed.device.type == "cpu"
        if on_cpu != (row_ids.device.type == "cpu"):
            raise ValueError(f"draw_rows: row_ids is on {row_ids.device}, the seed on "
                             f"{seed.device if torch.is_tensor(seed) else 'cpu'}")
        if on_cpu:
            dense = None if basis is None else _dense_basis(basis, n_flat // basis.shape[1])
            return _mirror_z(seed, row_ids, n_flat, dense, sampling)
        device = _check_cuda(seed, "draw_rows")
        rk.check_tensor(seed, "seed", torch.int32, (1,), device)
        if row_ids.device != device or row_ids.dim() != 1 or row_ids.numel() == 0:
            raise ValueError(f"row_ids must be [N > 0] on {device}, got {tuple(row_ids.shape)} on "
                             f"{row_ids.device}")
        horizon = n_flat if basis is None else basis.shape[1]
        if n_flat < 1 or n_flat % horizon:
            raise ValueError(f"n_flat ({n_flat}) is no multiple of the basis' horizon ({horizon})")
        code, n_cols, two_f, _ = _check_features(Features(sampling=sampling, basis=basis), 1,
                                                 horizon, n_flat // horizon, device)
        rows = row_ids.to(torch.int32).contiguous()
        z = torch.empty((rows.numel(), n_flat), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            err = _lib().bbmpc_draw_rows(
                seed.data_ptr(), rows.data_ptr(), z.data_ptr(), rows.numel(), horizon,
                n_flat // horizon, code, n_cols, two_f, _ptr(basis),
                torch.cuda.current_stream(device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"draw_rows kernel launch failed: CUDA error {err}")
        draw_rows.launches += 1
        return z


draw_rows.launches = 0


# ---------------------------------------------------------------- the solver-facing pair


def _seed_tensor(seed, device) -> torch.Tensor:
    """A seed tensor stays where it is (a wrapper raises on a wrong device); an int is made on
    ``device``."""
    if torch.is_tensor(seed):
        return seed.reshape(1).to(torch.int32)
    return torch.tensor([seed], dtype=torch.int32, device=device)


def make_fused_cem_kernels(
    config: LearnedDynamicsConfig,
    reward_fn: Callable,
    *,
    horizon: int,
    agents: int,
    population: int,
    tile: int = 256,
    streamed: bool = False,
    colored_noise_beta: float = 0.0,
    extra_slots: int = 0,
    sampling: str = "normal",
    aux_dot: bool = False,
    clip_bounds=None,
):
    """Builds ``(rollout_rewards, elite_moments)`` for the fused solver iterations.

    ``rollout_rewards(dp, s0 [A,S], mean [A,H,U], std [A,H,U], seed, extra=None, gvec=None)
    -> rewards [P, A]``, the undiscounted sum of ``reward_fn`` over each row's H transitions;
    ``elite_moments(mean, std, seed, mask [P, A], extra=None) -> (sum, sumsq)`` of the CENTERED
    samples ``x - mean``, each ``[A, H*U]`` (``mask`` may be any weights: PI2's softmax, CMA's
    log-rank). ``seed`` is an int or an int32 tensor on the inputs' device. Rows are
    population-major (row = p * A + a). ts1 runs one member per logical ``tile`` of rows, by
    the JAX package's seeded shuffle, exposed as ``rollout_rewards.tile_member_ids`` /
    ``.tile_rows``; ``tile`` must be a multiple of the CUDA kernels' ts1 row tile
    (``rk.TILE_TS1``).

    ``colored_noise_beta > 0`` draws iCEM colored candidates (z still clipped at +/-2);
    ``rollout_rewards.basis2`` is the matrix they are colored with (None if white).
    ``extra_slots > 0`` reserves the last population indices for injected candidates
    ``extra [extra_slots * A, H*U]`` (slot e, agent a at row ``e * A + a``).
    ``sampling="uniform"`` draws z ~ U(-1, 1). ``clip_bounds=(lower [U], upper [U])`` clips
    the candidates in both kernels and subtracts the squared violation from the rewards.
    ``aux_dot=True`` makes ``rollout_rewards`` return ``(rewards, dots [P, A])`` with
    ``dots = <gvec [A, H*U], centered>`` per row. The options run on the block kernel only.
    """
    kc.check_kernel_support(config, "fused CEM")
    dim_s, dim_u = config.dim_s, config.dim_u
    ensemble = config.ensemble_size
    ts1 = ensemble > 1 and config.propagation == "ts1"
    n_flat = horizon * dim_u
    rows = population * agents
    if sampling not in ("normal", "uniform"):
        raise ValueError(f"sampling must be 'normal' or 'uniform', got {sampling!r}")
    colored = colored_noise_beta > 0.0
    if colored and sampling == "uniform":
        raise ValueError("colored noise applies to normal sampling only")
    basis2_np = _colored_basis2(horizon, dim_u, colored_noise_beta) if colored else None
    n_cols = basis2_np.shape[0] if colored else n_flat  # RNG counters per row
    if extra_slots and population - extra_slots < 1:
        raise ValueError(f"extra_slots ({extra_slots}) must leave >= 1 fresh candidate")
    if clip_bounds is not None and extra_slots:
        raise ValueError("clip_bounds and extra_slots are mutually exclusive (no current "
                         "solver needs both; the penalty would be wrong on injected rows)")
    if streamed and (colored or extra_slots or ts1 or aux_dot or sampling != "normal"
                     or clip_bounds is not None):
        raise ValueError(
            "colored noise / injected candidates / ts1 / aux_dot / uniform sampling / "
            "clip_bounds run on the block fused kernels (the measured default); "
            "streamed=True supports the plain white-noise path only"
        )
    if rows * n_cols >= 2**32:
        raise ValueError(
            f"fused CEM candidate stream has {rows * n_cols} elements (>= 2^32); "
            "the int32 RNG counters would collide — reduce population/horizon"
        )
    if tile <= 0 or tile % rk.TILE_TS1:
        raise ValueError(f"tile ({tile}) must be a positive multiple of the CUDA row tile of "
                         f"ts1 ({rk.TILE_TS1})")
    cuda_tile = rk.tile_rows(ts1)
    n_tiles = kc.round_up(rows, tile) // tile
    if ts1:
        if n_tiles < ensemble:
            raise ValueError(
                f"ts1 fused CEM needs >= {ensemble} tiles (rows={rows}, tile={tile}) so "
                "every ensemble member is used; raise population or lower tile"
            )
        tile_members = np.resize(np.arange(ensemble, dtype=np.int32), n_tiles)
        np.random.default_rng(0x75B007).shuffle(tile_members)
    rows_pad = kc.round_up(rows, cuda_tile)  # the CUDA grid's padding; those rows are dropped
    operands = rk.operand_cache(config)
    launch = fused_rollout_streamed if streamed else fused_rollout
    flagged = colored or extra_slots or aux_dot or sampling != "normal" or clip_bounds is not None
    basis2 = torch.as_tensor(basis2_np) if colored else None

    def constants(device) -> Features:
        """The per-device part of the options: the basis in both forms and the bounds."""
        clip = None
        if clip_bounds is not None:
            clip = torch.as_tensor(np.stack([np.asarray(b, np.float32).reshape(dim_u)
                                             for b in clip_bounds]), device=device)
        on_device = basis2.to(device) if colored else None
        block = _basis_block(on_device, dim_u) if colored else None
        return Features(sampling=sampling, basis2=on_device, basis=block, clip=clip,
                        population=population if extra_slots else 0)

    constants_on = per_device(constants)
    members_on = per_device(lambda device: torch.as_tensor(tile_members, device=device))

    def features_for(device, extra, gvec=None):
        if not flagged:
            return None
        if extra_slots:
            if extra is None:
                raise ValueError("extra_slots > 0: pass extra [extra_slots*agents, H*U]")
            extra = extra.reshape(extra_slots * agents, n_flat).float().contiguous()
        else:
            extra = None
        return dataclasses.replace(constants_on(device), extra=extra, gvec=gvec)

    def rollout_rewards(dp: DynamicsParams, s0, mean, std, seed, extra=None, gvec=None):
        device = mean.device
        s0 = s0.float().contiguous()
        mean_f = mean.reshape(agents, n_flat).float().contiguous()
        std_f = std.reshape(agents, n_flat).float().contiguous()
        if aux_dot:
            if gvec is None:
                raise ValueError("aux_dot=True: pass gvec [A, H*U]")
            gvec = gvec.reshape(agents, n_flat).float().contiguous()
        else:
            gvec = None
        features = features_for(device, extra, gvec)
        out = launch(config, operands(dp), s0, mean_f, std_f, _seed_tensor(seed, device),
                     rows_pad, members_on(device) if ts1 else None, tile,
                     **({} if streamed else {"features": features}))
        states, actions = out[0], out[1]
        s0_rows = s0.repeat(-(-rows_pad // agents), 1)[:rows_pad]  # row r starts at s0[r % A]
        prev = torch.cat([s0_rows[None], states[:-1]])
        r = reward_fn(prev.reshape(-1, dim_s), actions.reshape(-1, dim_u),
                      states.reshape(-1, dim_s))
        total = r.reshape(horizon, rows_pad).sum(0)
        if clip_bounds is not None:
            total = total - out[2]  # rewards = evaluate(clipped) - penalty
        rewards = total[:rows].reshape(population, agents)
        if aux_dot:
            return rewards, out[3][:rows].reshape(population, agents)
        return rewards

    if ts1:
        rollout_rewards.tile_member_ids = tile_members
        rollout_rewards.tile_rows = tile
    rollout_rewards.basis2 = basis2  # the matrix the kernels color with (None if white)

    def moments(mean, std, seed, mask, extra=None):
        device = std.device
        mean_f = mean.reshape(agents, n_flat).float().contiguous()
        std_f = std.reshape(agents, n_flat).float().contiguous()
        weights = mask.float().reshape(rows).contiguous()
        return elite_moments(std_f, weights, _seed_tensor(seed, device), mean_f,
                             features_for(device, extra))

    return rollout_rewards, moments


# ---------------------------------------------------------------- the solvers


def _current(dp) -> Callable[[], DynamicsParams]:
    return dp if callable(dp) else (lambda: dp)


def _nan_guard(rewards: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(rewards), NAN_REWARD, rewards)


def _scatter_by_rank(values: torch.Tensor, index: torch.Tensor, population: int):
    """``out [P, A]`` with ``out[index[a, j], a] = values[j]`` (or 1.0 for ``values=None``)
    and 0 elsewhere; ``index [A, n]`` holds population indices, best first."""
    agents, n = index.shape
    src = (torch.ones((n, agents), dtype=torch.float32, device=index.device) if values is None
           else values[:, None].float().expand(n, agents))
    # A source already on the device: a Python scalar here would be copied from pageable host
    # memory, and that copy waits in the stream for the kernels before it.
    return torch.zeros((population, agents), dtype=torch.float32,
                       device=index.device).scatter_(0, index.T, src)


def check_candidate_layout(config) -> None:
    """The fused kernels draw and reduce ``[P, A, H, U]`` candidates: refuse ``time_major``."""
    if getattr(config, "time_major", False):
        raise ValueError(
            "time_major=True requires the eager evaluator; the 'fused' backend's candidate "
            "contract is [P, A, H, U]"
        )


def make_fused_cem(
    config: CEMConfig,
    bounds: Bounds,
    dyn_config: LearnedDynamicsConfig,
    dp: Union[DynamicsParams, Callable[[], DynamicsParams]],
    reward_fn: Callable,
    *,
    tile: int = 256,
    streamed: bool = False,
    _kernels: Callable[[int], tuple] | None = None,
    _round_to: int = 1,
) -> Solver:
    """CEM over the fused kernels, with the update rules and state of ``solvers/cem.py``.

    ``dp`` is the ``DynamicsParams`` or a function returning the current ones, read at every
    solve (``MPCPolicy`` passes its handler's); the packed weights are reused until a weight
    changes. Per iteration: a seed drawn on the device, ``std = sqrt(constrain_variance)``,
    rewards from K4 with the NaN guard, per-agent top-k -> 0/1 mask, centered moments from K6,
    ``new_mean = mean + csum / k``, ``new_var = max(csumsq / k - delta**2, 0)``, then the
    ``alpha`` blend. No step synchronises with the host: every value written lies on the
    device already (``chip_smoke.py`` counts the host's waits in one traced ``act()``).

    The iCEM options: ``colored_noise_beta`` colors the draws inside the kernels;
    ``mean_as_candidate`` and ``keep_elites`` fill the kernels' injected slots (the clipped
    mean first, then the carried elites), whose values :func:`draw_rows` draws again from the
    elite indices; ``population_decay`` builds one kernel pair per distinct population;
    ``execute_best`` acts with the best candidate seen over all iterations.

    ``_kernels(population)`` builds the ``(rollout_rewards, elite_moments)`` pair over that
    global population in place of :func:`make_fused_cem_kernels`, and each decayed population
    is rounded up to a multiple of ``_round_to``: the hooks the sharded solver reuses this
    update through (``ops/fused_sharded.py``).
    """
    check_config(config)
    check_candidate_layout(config)
    horizon, agents, pop, k = (
        config.planning_horizon, config.num_agents, config.population, config.num_elite,
    )
    keep, execute_best = config.keep_elites, config.execute_best
    if k > pop:
        raise ValueError(f"num_elite ({k}) must be <= population ({pop})")
    alpha = config.alpha
    n_flat = horizon * bounds.dim
    extra_slots = keep + (1 if config.mean_as_candidate else 0)

    def build_kernels(pop_i: int):
        if _kernels is not None:
            return _kernels(pop_i)
        return make_fused_cem_kernels(
            dyn_config, reward_fn, horizon=horizon, agents=agents, population=pop_i, tile=tile,
            streamed=streamed, colored_noise_beta=config.colored_noise_beta,
            extra_slots=extra_slots,
        )

    # Population decay: one kernel pair per distinct per-iteration population.
    pops = [-(-p // _round_to) * _round_to
            for p in iteration_populations(config) or [pop] * config.max_iterations]
    kernels_by_pop = {pop: build_kernels(pop)}
    for pop_i in set(pops) - {pop}:
        kernels_by_pop[pop_i] = build_kernels(pop_i)
    # draw_rows colors with the block of the matrix the kernels color with.
    basis2 = getattr(kernels_by_pop[pop][0], "basis2", None)
    basis_on = per_device(
        lambda device: None if basis2 is None else _basis_block(basis2.to(device), bounds.dim))
    n_extract = max(keep, 1 if execute_best else 0)
    current = _current(dp)

    def init(generator: torch.Generator) -> CEMState:
        device = generator.device
        return CEMState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=device),
            variance=base.init_solution_variance(bounds, horizon, agents, device=device),
        )

    def extract_values(seed, mean_f, std_f, idx, extra, fresh_i):
        """Elite values ``[A, n, H*U]`` of the population indices ``idx [A, n]``: K3 draws
        those rows again; injected slots (index >= ``fresh_i``) read ``extra`` back."""
        agent_ids = torch.arange(agents, device=idx.device)
        row_ids = (idx * agents + agent_ids[:, None]).reshape(-1)  # row = p * A + a
        z = draw_rows(seed, row_ids, n_flat, basis_on(idx.device)).reshape(agents, -1, n_flat)
        vals = mean_f[:, None, :] + std_f[:, None, :] * z
        if extra_slots:
            slot = torch.clamp(idx - fresh_i, 0, extra_slots - 1)
            table = extra.reshape(extra_slots, agents, n_flat).transpose(0, 1)  # [A, slots, n]
            injected = torch.gather(table, 1, slot[:, :, None].expand(-1, -1, n_flat))
            vals = torch.where((idx >= fresh_i)[:, :, None], injected, vals)
        return vals

    def solve(state: CEMState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        params = current()
        mean, var = state.mean, state.variance
        device = mean.device
        best_val = torch.full((agents,), -torch.inf, dtype=mean.dtype, device=device)
        best_plan = mean.reshape(agents, n_flat)
        carried = None
        if keep:
            # Placeholders sampled around the incoming plan, through the counter RNG.
            z0 = draw_rows(draw_seed(generator),
                           torch.arange(keep * agents, dtype=torch.int32, device=device), n_flat,
                           basis_on(device))
            carried = (mean.reshape(agents, n_flat)[:, None]
                       + torch.sqrt(var).reshape(agents, n_flat)[:, None]
                       * z0.reshape(keep, agents, n_flat).transpose(0, 1))  # [A, keep, n]
        for pop_i in pops:
            rollout_rewards, moments = kernels_by_pop[pop_i]
            seed = draw_seed(generator)
            std = torch.sqrt(base.constrain_variance(mean, var, bounds))
            extra = ()
            if extra_slots:
                # [extra_slots, A, n_flat]: the clipped mean first, then the carried elites.
                parts = []
                if config.mean_as_candidate:
                    parts.append(bounds.clip(mean).reshape(1, agents, n_flat))
                if keep:
                    parts.append(carried.transpose(0, 1))
                extra = (torch.cat(parts, dim=0),)
            rewards = _nan_guard(rollout_rewards(params, obs, mean, std, seed, *extra))  # [P, A]
            elite_vals, elite_idx = torch.topk(rewards.T, k, dim=1)  # [A, k]
            mask = _scatter_by_rank(None, elite_idx, pop_i)
            csum, csumsq = moments(mean, std, seed, mask, *extra)
            delta = (csum / k).reshape(agents, horizon, bounds.dim)
            new_mean = mean + delta
            new_var = torch.clamp_min(
                (csumsq / k).reshape(agents, horizon, bounds.dim) - torch.square(delta), 0.0
            )
            if n_extract:
                vals = extract_values(
                    seed, mean.reshape(agents, n_flat), std.reshape(agents, n_flat),
                    elite_idx[:, :n_extract], extra[0] if extra else None,
                    pop_i - extra_slots,
                )  # ranked best first
                if keep:
                    carried = vals[:, :keep]
                if execute_best:
                    improve = elite_vals[:, 0] > best_val
                    best_val = torch.where(improve, elite_vals[:, 0], best_val)
                    best_plan = torch.where(improve[:, None], vals[:, 0], best_plan)
            mean = alpha * mean + (1.0 - alpha) * new_mean
            var = alpha * var + (1.0 - alpha) * new_var
        if execute_best:
            best_plan = best_plan.reshape(agents, horizon, bounds.dim)
            action = best_plan[:, 0]
            aux = SolverAux(expected_reward=best_val, plan=best_plan)
        else:
            action = mean[:, 0]
            aux = SolverAux(expected_reward=torch.mean(elite_vals, dim=1), plan=mean)
        if config.warm_start:
            next_state = CEMState(mean=base.shift_time(mean), variance=state.variance)
        else:
            next_state = state
        return action, next_state, aux

    def reset(state: CEMState, generator: torch.Generator) -> CEMState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CEM-Fused", plan_field="mean"),
        config.dtype,
    )


def make_fused_pi2(
    config: PI2Config,
    bounds: Bounds,
    dyn_config: LearnedDynamicsConfig,
    dp: Union[DynamicsParams, Callable[[], DynamicsParams]],
    reward_fn: Callable,
    *,
    tile: int = 256,
    _kernels=None,
) -> Solver:
    """PI2/MPPI over the fused kernels, with the update of ``solvers/pi2.py``.

    The PI2 update is a weighted first and second moment of the population, and K6 takes any
    weights: the per-row softmax weights in place of the elite mask give ``sum w (x - mean)``
    and ``sum w (x - mean)^2`` without the candidates. MPPI's control cost is K4's dot output
    ``<mean / variance, centered>``. As in the eager solver the candidates are clipped to the
    bounds inside the kernels and the squared violation is subtracted from each row's reward.
    What differs: z is clipped at +/-2, not resampled. ``_kernels`` injects
    ``(rollout_rewards, weighted_moments)`` over the global population, as in
    :func:`make_fused_sep_cma`.
    """
    check_candidate_layout(config)
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    lamda = config.lamda
    rollout_rewards, weighted_moments = _kernels or make_fused_cem_kernels(
        dyn_config, reward_fn, horizon=horizon, agents=agents, population=pop, tile=tile,
        colored_noise_beta=config.colored_noise_beta, aux_dot=config.control_cost,
        clip_bounds=(bounds.lower, bounds.upper),
    )
    current = _current(dp)

    def init(generator: torch.Generator) -> PI2State:
        return PI2State(
            mean=base.init_solution_mean(bounds, horizon, agents, device=generator.device))

    def solve(state: PI2State, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        params = current()
        mean = state.mean
        variance0 = base.init_solution_variance(bounds, horizon, agents, device=mean.device)
        variance = variance0
        for _ in range(config.max_iterations):
            seed = draw_seed(generator)
            std = torch.sqrt(variance)
            if config.control_cost:
                rewards, dots = rollout_rewards(params, obs, mean, std, seed,
                                                gvec=mean / variance)
            else:
                rewards = rollout_rewards(params, obs, mean, std, seed)
            rewards = _nan_guard(rewards)
            costs = -rewards
            if config.control_cost:
                costs = costs + lamda * dots
            wsum, wsumsq = weighted_moments(mean, std, seed, softmax_weights(costs, lamda))
            delta = wsum.reshape(agents, horizon, bounds.dim)
            if config.adapt_variance:
                new_var = wsumsq.reshape(agents, horizon, bounds.dim) - torch.square(delta)
                variance = torch.maximum(new_var, config.variance_floor_frac * variance0)
            mean = mean + delta
        aux = SolverAux(expected_reward=rewards.max(dim=0).values, plan=mean)
        return mean[:, 0], PI2State(mean=base.shift_time(mean)), aux

    def reset(state: PI2State, generator: torch.Generator) -> PI2State:
        del state
        return init(generator)

    name = "MPPI-Fused" if config.control_cost else "PI2-Fused"
    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name=name, plan_field="mean"), config.dtype)


def make_fused_random_search(
    config: RandomSearchConfig,
    bounds: Bounds,
    dyn_config: LearnedDynamicsConfig,
    dp: Union[DynamicsParams, Callable[[], DynamicsParams]],
    reward_fn: Callable,
    *,
    tile: int = 256,
    _kernels=None,
    _name: str = "RandomSearch-Fused",
) -> Solver:
    """RandomSearch over the fused kernels: K4 draws uniform-in-bounds candidates
    (``sampling="uniform"`` around the midpoint with the half range as std) and only the
    rewards ``[P, A]`` come back; :func:`draw_rows` draws the per-agent argmax row again.

    ``_kernels`` injects ``(rollout_rewards, draw_winners)`` over the global population, with
    ``draw_winners(seed, best_idx [A], agent_ids [A]) -> z [A, H*U]`` drawing each agent's
    winning row again: the hook a sharded solver reuses this solve through."""
    check_candidate_layout(config)
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    n_flat = horizon * bounds.dim
    if _kernels is not None:
        rollout_rewards, draw_winners = _kernels
    else:
        rollout_rewards, _ = make_fused_cem_kernels(
            dyn_config, reward_fn, horizon=horizon, agents=agents, population=pop, tile=tile,
            sampling="uniform",
        )

        def draw_winners(seed, best_idx, agent_ids):
            return draw_rows(seed, best_idx * agents + agent_ids, n_flat, sampling="uniform")

    current = _current(dp)

    def box(device):
        lower, upper = bounds.on(device)
        mid = base.init_solution_mean(bounds, horizon, agents, device=device)
        return mid, ((upper - lower) / 2.0).expand(mid.shape).contiguous()

    box_on = per_device(box)

    def init(generator: torch.Generator) -> RandomSearchState:
        del generator
        return RandomSearchState()

    def solve(state: RandomSearchState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        mid, half = box_on(obs.device)
        seed = draw_seed(generator)
        rewards = _nan_guard(rollout_rewards(current(), obs, mid, half, seed))  # [P, A]
        best_idx = torch.argmax(rewards, dim=0)  # [A]
        agent_ids = torch.arange(agents, device=obs.device)
        z = draw_winners(seed, best_idx, agent_ids)
        best_plan = (mid.reshape(agents, n_flat) + half.reshape(agents, n_flat) * z).reshape(
            agents, horizon, bounds.dim)
        aux = SolverAux(expected_reward=rewards[best_idx, agent_ids], plan=best_plan)
        return best_plan[:, 0], state, aux

    def reset(state: RandomSearchState, generator: torch.Generator) -> RandomSearchState:
        del generator
        return state

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name=_name), config.dtype)


def make_fused_sep_cma(
    config: CMAESConfig,
    bounds: Bounds,
    dyn_config: LearnedDynamicsConfig,
    dp: Union[DynamicsParams, Callable[[], DynamicsParams]],
    reward_fn: Callable,
    *,
    tile: int = 256,
    _kernels=None,
    _name: str = "sep-CMA-Fused",
) -> Solver:
    """sep-CMA-ES over the fused kernels, with the diagonal update of ``solvers/cma_es.py``.

    The diagonal update needs two weighted moments of the population: ``sum w (x - mean)``
    (the recombination step) and ``sum w (x - mean)^2`` (the diagonal rank-mu term), which is
    K6 with the log-rank weights scattered by reward order. K4 samples with the per-coordinate
    std ``sigma * sqrt(diag C)``, clips to the bounds and subtracts the violation penalty. The
    strategy constants are :func:`cma.cma_constants`, shared with the eager solver. The full
    covariance cannot fuse (its rank-mu update is an ``[n, n]`` outer-product sum): this
    requires ``config.diagonal=True``.

    z is clipped at +/-2, which deflates second moments by E[clip(z)^2] = 0.9205 against the
    N(0, 1) the constants assume, so the rank-mu term is rescaled by 1 / 0.9205; the step-size
    path keeps the residual bias. ``_kernels`` injects ``(rollout_rewards, weighted_moments)``
    over the global population, the hook a sharded solver reuses this update through.
    """
    if not config.diagonal:
        raise ValueError(
            "the fused CMA-ES is sep-CMA only (diagonal=True): the full-covariance rank-mu "
            "update needs the [n, n] outer-product reduction, which does not fit the "
            "moment-regeneration scheme — use the eager solver for full CMA-ES"
        )
    horizon, agents, pop, k = (
        config.planning_horizon, config.num_agents, config.population, config.num_elite,
    )
    C = cma.cma_constants(config, bounds, horizon, pop, k)
    n = C.n
    if _kernels is not None:
        rollout_rewards, weighted_moments = _kernels
    else:
        rollout_rewards, weighted_moments = make_fused_cem_kernels(
            dyn_config, reward_fn, horizon=horizon, agents=agents, population=pop, tile=tile,
            clip_bounds=(bounds.lower, bounds.upper),
        )
    current = _current(dp)

    def init(generator: torch.Generator) -> CMAESState:
        return cma.init_state(bounds, horizon, agents, True, generator.device)

    def solve(state: CMAESState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        params = current()
        s = state
        if not config.persist_across_solves:
            s = dataclasses.replace(init(generator), mean=state.mean)
        weights = C.weights_on(s.mean.device)
        for _ in range(config.max_iterations):
            seed = draw_seed(generator)
            std_eff = s.sigma * s.chol  # per-coordinate sigma * sqrt(diag C), [A, n]
            rewards = _nan_guard(rollout_rewards(params, obs, s.mean, std_eff, seed))
            # Log-rank recombination weights scattered to each row by reward order.
            order = torch.argsort(-rewards.T, dim=1, stable=True)  # [A, P], best first
            omega = _scatter_by_rank(weights, order, pop)
            x_mean, csumsq = weighted_moments(s.mean, std_eff, seed, omega)  # post-clip, [A, n]
            y_mean = x_mean / s.sigma
            p_sigma, sigma, p_cov, delta = cma.step_size_update(
                config, C, s, y_mean, s.inv_sqrt * y_mean)
            # sum w ((x - mean) / sigma)^2, rescaled for the clipped sampling.
            rank_mu_d = csumsq / torch.square(s.sigma) / _CLIPPED_Z_SECOND_MOMENT
            cov, chol, inv_sqrt = cma.diagonal_cov_update(C, s, p_cov, delta, rank_mu_d)
            s = CMAESState(mean=s.mean + x_mean, sigma=sigma, cov=cov, p_sigma=p_sigma,
                           p_cov=p_cov, chol=chol, inv_sqrt=inv_sqrt, gen=s.gen + 1)
        plan = s.mean.reshape(agents, horizon, bounds.dim)
        if not config.persist_across_solves:
            s = dataclasses.replace(s, mean=base.shift_time(plan).reshape(agents, n))
        aux = SolverAux(expected_reward=rewards.max(dim=0).values, plan=plan)
        return plan[:, 0], s, aux

    def reset(state: CMAESState, generator: torch.Generator) -> CMAESState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name=_name, plan_field="mean"), config.dtype)
