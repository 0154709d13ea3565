"""K3-K6: the generate-in-kernel CEM as hand-written CUDA kernels, with their plain versions.

Counterpart of ``blackbox_mpc_tpu/ops/pallas_cem.py:58-826`` at the plain-CEM path (white
clipped-normal noise, no injected candidates, no bounds clip). The candidate tensor
``[P, A, H, U]`` is never stored: K4 draws each row's actions from a counter-based RNG and
rolls them out, and K6 regenerates the same draws to reduce the elite moments.

* K3, the counter RNG (``_mix``, ``_uniform``, ``_normal``, ``_gen_z``, ``_tile_counter``,
  ``_mirror_z``): here in torch, in int64 masked to 32 bits, the same integers as the JAX
  package's uint32 stream bit for bit; in ``ops/csrc/fused_cem.cu`` as device functions.
* K4 :func:`fused_rollout` and K5 :func:`fused_rollout_streamed` (``kernel_a``,
  ``kernel_a_streamed``): sample + roll out, returning the visited states and the drawn
  actions, time-major. The caller applies its torch ``reward_fn`` to them (a CUDA library
  cannot call it), as ``ops/rollout_kernel.py`` does for K2.
* K6 :func:`elite_moments` (``kernel_b``): regenerate + weighted centered moments.

Each wrapper takes its plain version for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises, and adds one to its ``launches`` where it launches. What bounds each kernel
on the H100 is in the CUDA source's note. :func:`make_fused_cem_kernels` and
:func:`make_fused_cem` keep the JAX package's signatures and semantics, without its
``interpret`` flag: the device of the tensors picks the route.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.rollout.evaluator import NAN_REWARD
from blackbox_mpc_torch.solvers import base
from blackbox_mpc_torch.solvers.cem import CEMConfig, CEMState, check_config

__all__ = [
    "draw_seed", "elite_moments", "elite_moments_plain", "fused_rollout", "fused_rollout_plain",
    "fused_rollout_streamed", "make_fused_cem", "make_fused_cem_kernels",
]

TILE = rk.TILE  # rows per CTA, as in the rollout kernel
_M32 = 0xFFFFFFFF
_PHI = 0x9E3779B1
_SEED2_OFFSET = 0x632BE5AB  # Box-Muller's second uniform
# 2 pi rounded to float32: JAX multiplies a float32 by the weak-typed Python float, which rounds
# the constant to float32 first.
_TWO_PI = float(np.float32(2.0 * np.pi))
# K6 reduces chunks of at least this many population indices, and at most this many chunks.
MOMENT_CHUNK = 8
MAX_MOMENT_CHUNKS = 256

_ICEM_TODO = "is not ported yet (ROADMAP Queue 1 item 4: the iCEM options)"
_FAMILY_TODO = (
    "is not ported yet (ROADMAP Queue 1 items 8 and 10: the fused PI2/MPPI, RandomSearch and "
    "sep-CMA solvers)"
)


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


def _gen_z(counter: torch.Tensor, seed, basis2=None, sampling: str = "normal") -> torch.Tensor:
    """The clipped N(0, 1) draw of each counter: ``clip(normal, -2, 2)``, clipped after
    Box-Muller."""
    if basis2 is not None:
        raise NotImplementedError(f"colored noise {_ICEM_TODO}")
    if sampling != "normal":
        raise NotImplementedError(f"sampling={sampling!r} {_FAMILY_TODO}")
    return torch.clamp(_normal(counter, seed), -2.0, 2.0)


def _tile_counter(row0: int, t_rows: int, n_cols: int, device=None) -> torch.Tensor:
    """``[T, C]`` element counters of rows ``[row0, row0 + T)``: counter = row * C + col."""
    rows = row0 + torch.arange(t_rows, dtype=torch.int64, device=device)
    return rows[:, None] * n_cols + torch.arange(n_cols, dtype=torch.int64, device=device)


def _mirror_z(seed, row_ids: torch.Tensor, n_flat: int, basis2=None,
              sampling: str = "normal") -> torch.Tensor:
    """The draws ``[N, n_flat]`` of arbitrary rows ``row_ids [N]``, the same as the kernels'."""
    cols = torch.arange(n_flat, dtype=torch.int64, device=row_ids.device)
    return _gen_z(row_ids.to(torch.int64)[:, None] * n_flat + cols, seed, basis2, sampling)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """One seed in ``[0, 2**31 - 1)`` as an int32 ``[1]`` tensor on the generator's device (the
    JAX range, ``pallas_cem.py:735``): no host round trip."""
    return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device,
                         dtype=torch.int32)


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
    tile_member: torch.Tensor | None = None, member_tile: int = TILE, streamed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 (and of K5 with ``streamed=True``, which draws step h's actions at
    step h): the same inputs and the same ``(states [H, rows, S], actions [H, rows, U])``, at
    any row count. Row r belongs to agent ``r % A``; for ts1 it runs member
    ``tile_member[r // member_tile]``."""
    agents, hu = mean.shape
    dim_u = config.dim_u
    horizon = hu // dim_u
    row_ids = torch.arange(rows, device=mean.device)
    agent = row_ids % agents
    mean_rows, std_rows = mean[agent], std[agent]
    if streamed:
        cols = torch.arange(dim_u, device=mean.device)
        steps = []
        for h in range(horizon):
            z = _gen_z(row_ids[:, None] * hu + h * dim_u + cols, seed)
            cut = slice(h * dim_u, (h + 1) * dim_u)
            steps.append(mean_rows[:, cut] + std_rows[:, cut] * z)
        actions = torch.stack(steps)
    else:
        z = _mirror_z(seed, row_ids, hu)
        actions = (mean_rows + std_rows * z).reshape(rows, horizon, dim_u).transpose(0, 1)
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
    return states, actions.contiguous()


def _lib():
    from blackbox_mpc_torch.ops._build import load_library

    lib = load_library("fused_cem")
    if not getattr(lib, "_bbmpc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        rollout_args = [p] * 5 + [i] + [p] * 5 + [i] * 8 + [p] + [i] * 4 + [p]
        lib.bbmpc_fused_rollout.argtypes = rollout_args
        lib.bbmpc_fused_rollout.restype = i
        lib.bbmpc_fused_rollout_streamed.argtypes = rollout_args
        lib.bbmpc_fused_rollout_streamed.restype = i
        lib.bbmpc_elite_moments.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.bbmpc_elite_moments.restype = i
        lib._bbmpc_typed = True
    return lib


def _check_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")
    return t.device


def _launch_rollout(
    streamed: bool, config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0, mean, std, seed,
    rows: int, tile_member, member_tile: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    what = "fused_rollout_streamed" if streamed else "fused_rollout"
    device = _check_cuda(mean, what)
    kc.check_kernel_support(config, what)
    agents, hu = mean.shape
    dim_s, dim_u = config.dim_s, config.dim_u
    if hu % dim_u or rows % TILE or rows < 1:
        raise ValueError(f"{what}: mean width {hu} must be H * U (U={dim_u}) and rows ({rows}) "
                         f"a positive multiple of the tile ({TILE})")
    horizon = hu // dim_u
    rk.check_tensor(mean, "mean", torch.float32, (agents, hu), device)
    rk.check_tensor(std, "std", torch.float32, (agents, hu), device)
    rk.check_tensor(s0, "s0", torch.float32, (agents, dim_s), device)
    rk.check_tensor(seed, "seed", torch.int32, (1,), device)
    widths = rk.check_operands(config, ops, device)
    if tile_member is not None:
        if member_tile <= 0 or member_tile % TILE:
            raise ValueError(f"member_tile ({member_tile}) must be a multiple of {TILE}")
        rk.check_tensor(tile_member, "tile_member", torch.int32,
                        (-(-rows // member_tile),), device)
    states = torch.empty((horizon, rows, dim_s), dtype=torch.float32, device=device)
    actions = torch.empty((horizon, rows, dim_u), dtype=torch.float32, device=device)
    lib = _lib()
    entry = lib.bbmpc_fused_rollout_streamed if streamed else lib.bbmpc_fused_rollout
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(
            s0.data_ptr(), mean.data_ptr(), std.data_ptr(), seed.data_ptr(),
            None if tile_member is None else tile_member.data_ptr(), member_tile,
            ops.stats.data_ptr(), ops.packed_w.data_ptr(), ops.packed_b.data_ptr(),
            states.data_ptr(), actions.data_ptr(), horizon, rows, agents, dim_s, dim_u,
            ops.stats.shape[1], config.ensemble_size, len(widths) - 1, rk.int_array(widths),
            kc.KERNEL_ACTIVATIONS[config.activation], int(config.normalized),
            int(config.predict_delta), int(config.compute_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    return states, actions


def fused_rollout(
    config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor, seed: torch.Tensor, rows: int,
    tile_member: torch.Tensor | None = None, member_tile: int = TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper: ``s0 [A, S]``, ``mean``/``std [A, H*U]``, ``seed [1]`` int32 ->
    ``(states [H, rows, S], actions [H, rows, U])`` for rows ``p * A + a`` (``rows`` a multiple
    of 4 on the card). CPU tensors take :func:`fused_rollout_plain`."""
    if mean.device.type == "cpu":
        return fused_rollout_plain(config, ops, s0, mean, std, seed, rows, tile_member,
                                   member_tile)
    out = _launch_rollout(False, config, ops, s0, mean, std, seed, rows, tile_member,
                          member_tile)
    fused_rollout.launches += 1
    return out


def fused_rollout_streamed(
    config: LearnedDynamicsConfig, ops: rk.KernelOperands, s0: torch.Tensor,
    mean: torch.Tensor, std: torch.Tensor, seed: torch.Tensor, rows: int,
    tile_member: torch.Tensor | None = None, member_tile: int = TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's wrapper: the same function as :func:`fused_rollout`, by the kernel that draws step
    h's actions inside step h."""
    if mean.device.type == "cpu":
        return fused_rollout_plain(config, ops, s0, mean, std, seed, rows, tile_member,
                                   member_tile, streamed=True)
    out = _launch_rollout(True, config, ops, s0, mean, std, seed, rows, tile_member,
                          member_tile)
    fused_rollout_streamed.launches += 1
    return out


fused_rollout.launches = 0
fused_rollout_streamed.launches = 0


# ---------------------------------------------------------------- K6: elite moments


def elite_moments_plain(std: torch.Tensor, weights: torch.Tensor, seed):
    """Plain version of K6: for ``centered = std[a] * z(row)``, row ``p * A + a``, the sums over
    the population of ``w * centered`` and ``w * centered**2``, each ``[A, H*U]``."""
    agents, hu = std.shape
    population = weights.shape[0] // agents
    z = _mirror_z(seed, torch.arange(population * agents, device=std.device), hu)
    centered = (std.repeat(population, 1) * z).reshape(population, agents, hu)
    w = weights.reshape(population, agents, 1)
    return (w * centered).sum(0), (w * (centered * centered)).sum(0)


def elite_moments(std: torch.Tensor, weights: torch.Tensor, seed: torch.Tensor):
    """K6's wrapper: ``std [A, H*U]``, ``weights [P * A]`` (row ``p * A + a``; a 0/1 elite mask
    or any weights), ``seed [1]`` int32 -> ``(sum, sumsq)``, each ``[A, H*U]``. CPU tensors take
    :func:`elite_moments_plain`."""
    if std.device.type == "cpu":
        return elite_moments_plain(std, weights, seed)
    device = _check_cuda(std, "elite_moments")
    agents, hu = std.shape
    rows = weights.numel()
    if weights.dim() != 1 or rows == 0 or rows % agents:
        raise ValueError(f"weights must be [population * {agents}], got {tuple(weights.shape)}")
    population = rows // agents
    rk.check_tensor(std, "std", torch.float32, (agents, hu), device)
    rk.check_tensor(weights, "weights", torch.float32, (rows,), device)
    rk.check_tensor(seed, "seed", torch.int32, (1,), device)
    chunk = max(MOMENT_CHUNK, -(-population // MAX_MOMENT_CHUNKS))
    partial = torch.empty((-(-population // chunk), 2, agents * hu), dtype=torch.float32,
                          device=device)
    out = torch.empty((2, agents, hu), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().bbmpc_elite_moments(
            std.data_ptr(), weights.data_ptr(), seed.data_ptr(), partial.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), population, agents, hu, chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"elite_moments kernel launch failed: CUDA error {err}")
    elite_moments.launches += 1
    return out[0], out[1]


elite_moments.launches = 0


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

    ``rollout_rewards(dp, s0 [A,S], mean [A,H,U], std [A,H,U], seed) -> rewards [P, A]``, the
    undiscounted sum of ``reward_fn`` over each row's H transitions;
    ``elite_moments(mean, std, seed, mask [P, A]) -> (sum, sumsq)`` of the CENTERED samples
    ``x - mean``, each ``[A, H*U]``. ``seed`` is an int or an int32 tensor on the inputs'
    device. Rows are population-major (row = p * A + a). ts1 runs one member per logical
    ``tile`` of rows, by the JAX package's seeded shuffle, exposed as
    ``rollout_rewards.tile_member_ids`` / ``.tile_rows``; ``tile`` must be a multiple of the
    CUDA row tile (4).

    The iCEM options (``colored_noise_beta``, ``extra_slots``) and the flags of the other fused
    solvers (``sampling="uniform"``, ``aux_dot``, ``clip_bounds``) raise
    ``NotImplementedError``.
    """
    kc.check_kernel_support(config, "fused CEM")
    if sampling not in ("normal", "uniform"):
        raise ValueError(f"sampling must be 'normal' or 'uniform', got {sampling!r}")
    if colored_noise_beta > 0.0 or extra_slots:
        raise NotImplementedError(f"colored_noise_beta / extra_slots {_ICEM_TODO}")
    if sampling != "normal" or aux_dot or clip_bounds is not None:
        raise NotImplementedError(f"sampling='uniform' / aux_dot / clip_bounds {_FAMILY_TODO}")
    dim_s, dim_u = config.dim_s, config.dim_u
    ensemble = config.ensemble_size
    ts1 = ensemble > 1 and config.propagation == "ts1"
    if streamed and ts1:
        raise ValueError("streamed=True supports the plain white-noise path only (no ts1), as "
                         "in the JAX package")
    n_flat = horizon * dim_u
    rows = population * agents
    if rows * n_flat >= 2**32:
        raise ValueError(
            f"fused CEM candidate stream has {rows * n_flat} elements (>= 2^32); "
            "the int32 RNG counters would collide — reduce population/horizon"
        )
    if tile <= 0 or tile % TILE:
        raise ValueError(f"tile ({tile}) must be a positive multiple of the CUDA row tile ({TILE})")
    n_tiles = kc.round_up(rows, tile) // tile
    if ts1:
        if n_tiles < ensemble:
            raise ValueError(
                f"ts1 fused CEM needs >= {ensemble} tiles (rows={rows}, tile={tile}) so "
                "every ensemble member is used; raise population or lower tile"
            )
        tile_members = np.resize(np.arange(ensemble, dtype=np.int32), n_tiles)
        np.random.default_rng(0x75B007).shuffle(tile_members)
    rows_pad = kc.round_up(rows, TILE)  # the CUDA grid's padding; those rows are dropped
    operands = rk.operand_cache(config)
    launch = fused_rollout_streamed if streamed else fused_rollout
    members_on = {}

    def rollout_rewards(dp: DynamicsParams, s0, mean, std, seed):
        device = mean.device
        s0 = s0.float().contiguous()
        mean_f = mean.reshape(agents, n_flat).float().contiguous()
        std_f = std.reshape(agents, n_flat).float().contiguous()
        members = None
        if ts1:
            if device not in members_on:
                members_on[device] = torch.as_tensor(tile_members, device=device)
            members = members_on[device]
        states, actions = launch(config, operands(dp), s0, mean_f, std_f,
                                 _seed_tensor(seed, device), rows_pad, members, tile)
        s0_rows = s0.repeat(-(-rows_pad // agents), 1)[:rows_pad]  # row r starts at s0[r % A]
        prev = torch.cat([s0_rows[None], states[:-1]])
        r = reward_fn(prev.reshape(-1, dim_s), actions.reshape(-1, dim_u),
                      states.reshape(-1, dim_s))
        return r.reshape(horizon, rows_pad).sum(0)[:rows].reshape(population, agents)

    if ts1:
        rollout_rewards.tile_member_ids = tile_members
        rollout_rewards.tile_rows = tile

    def moments(mean, std, seed, mask):
        del mean  # the centered samples std * z need no mean without a bounds clip
        std_f = std.reshape(agents, n_flat).float().contiguous()
        weights = mask.float().reshape(rows).contiguous()
        return elite_moments(std_f, weights, _seed_tensor(seed, std.device))

    return rollout_rewards, moments


def make_fused_cem(
    config: CEMConfig,
    bounds: Bounds,
    dyn_config: LearnedDynamicsConfig,
    dp: Union[DynamicsParams, Callable[[], DynamicsParams]],
    reward_fn: Callable,
    *,
    tile: int = 256,
    streamed: bool = False,
) -> Solver:
    """CEM over the fused kernels, with the update rules and state of ``solvers/cem.py``.

    ``dp`` is the ``DynamicsParams`` or a function returning the current ones, read at every
    solve (``MPCPolicy`` passes its handler's); the packed weights are reused until a weight
    changes. Per iteration: a seed drawn on the device, ``std = sqrt(constrain_variance)``,
    rewards from K4 with the NaN guard, per-agent top-k -> 0/1 mask, centered moments from K6,
    ``new_mean = mean + csum / k``, ``new_var = max(csumsq / k - delta**2, 0)``, then the
    ``alpha`` blend. No step synchronises with the host.
    """
    check_config(config)
    horizon, agents, pop, k = (
        config.planning_horizon, config.num_agents, config.population, config.num_elite,
    )
    if k > pop:
        raise ValueError(f"num_elite ({k}) must be <= population ({pop})")
    alpha = config.alpha
    rollout_rewards, moments = make_fused_cem_kernels(
        dyn_config, reward_fn, horizon=horizon, agents=agents, population=pop, tile=tile,
        streamed=streamed,
    )
    current = dp if callable(dp) else (lambda: dp)

    def init(generator: torch.Generator) -> CEMState:
        device = generator.device
        return CEMState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=device),
            variance=base.init_solution_variance(bounds, horizon, agents, device=device),
        )

    def solve(state: CEMState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        params = current()
        mean, var = state.mean, state.variance
        agent_ids = torch.arange(agents, device=mean.device)
        for _ in range(config.max_iterations):
            seed = draw_seed(generator)
            std = torch.sqrt(base.constrain_variance(mean, var, bounds))
            rewards = rollout_rewards(params, obs, mean, std, seed)  # [P, A]
            rewards = torch.where(torch.isnan(rewards), NAN_REWARD, rewards)
            elite_vals, elite_idx = torch.topk(rewards.T, k, dim=1)  # [A, k]
            mask = torch.zeros((pop, agents), dtype=torch.float32, device=mean.device)
            mask[elite_idx.T, agent_ids[None, :]] = 1.0
            csum, csumsq = moments(mean, std, seed, mask)
            delta = (csum / k).reshape(agents, horizon, bounds.dim)
            new_mean = mean + delta
            new_var = torch.clamp_min(
                (csumsq / k).reshape(agents, horizon, bounds.dim) - torch.square(delta), 0.0
            )
            mean = alpha * mean + (1.0 - alpha) * new_mean
            var = alpha * var + (1.0 - alpha) * new_var
        aux = SolverAux(expected_reward=torch.mean(elite_vals, dim=1), plan=mean)
        if config.warm_start:
            next_state = CEMState(mean=base.shift_time(mean), variance=state.variance)
        else:
            next_state = state
        return mean[:, 0], next_state, aux

    def reset(state: CEMState, generator: torch.Generator) -> CEMState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CEM-Fused", plan_field="mean"),
        config.dtype,
    )
