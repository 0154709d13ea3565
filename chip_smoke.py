"""Smoke test of the PyTorch/CUDA port (blackbox_mpc_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package. Phases, each fatal on failure:

1. device: print the card's name and power limit (``nvidia-smi``); no CUDA -> exit 2.
2. build: compile the port's CUDA sources with ``nvcc``, one process per source, together.
3. kernel vs plain at the flagship shape (rows=1000, H=50, a 5-member 3x500 tanh ensemble,
   S=17, U=6, seeded random weights, non-trivial normalizer stats), each kernel against its
   plain PyTorch version on the same inputs, with the times of both and the analytic bound:
   - the rollout kernel (K2 with K1 inside) for mean/f32, mean/bf16 and ts1/f32: the whole
     visited-state tensor [H, rows, S] and the rewards summed from it;
   - the fused sample + rollout kernel (K4, with the counter RNG K3) for mean/f32, mean/bf16
     and ts1/f32 (logical tile 128, so 8 tiles for 5 members), and its streamed form (K5)
     for mean/f32: the drawn actions, the visited states and the rewards;
   - K2 and K4 (mean/f32) again on rows=3000, three agents at population 1000;
   each of these launches on the rows padded to the kernel's tile, as the evaluators pad
   them, and prints its cluster size, tile, cudaOccupancyMaxActiveClusters, the waves the
   grid needs, shared memory, registers and local bytes;
   - K4 with its options (mean/f32): the iCEM set (colored noise beta 2, 6 injected
     candidates), the MPPI set (bounds clip with its penalty, the dot) and uniform sampling;
   - the row draw (K3 on its own, ``draw_rows``) against its plain version ``_mirror_z``, bit
     for bit for white and uniform draws and within 1e-6 for colored ones, and against K4
     itself: at mean 0 and std 1 the actions K4 rolled out are its draws, and ``draw_rows``
     must give them bit for bit, white, uniform and colored;
   - the elite-moment kernel (K6) with a 50-elite 0/1 mask, softmax weights, sep-CMA's
     log-rank weights, all zeros and one nonzero row, plain and with the options colored +
     injected and bounds clip; every case must also repeat bit for bit, and K6 must give the
     centered actions K4 rolled out, bit for bit, for a one-hot weight;
   K3 and K6 are timed twice: the host's time of a call (back-to-back calls between two
   events) and the device's (20 calls captured in a CUDA graph, replayed between two events).
4. reference on a small input: the kernel evaluator against the eager evaluator, and the
   fused kernels, plain and with each solver's option set, against the same closures on CPU
   tensors (the plain versions).
5. slice: ``MPCPolicy`` at the flagship settings (pop=1000, 50 elites, 5 iterations) acts 3
   steps after a warm-up, closing the loop through the model: CEM on the ``"kernel"`` and on
   the ``"fused"`` backend, then on ``"fused"`` CEM with the iCEM options, MPPI, RandomSearch
   and CMA-ES (diagonal). Actions must be finite and in bounds, and each kernel's launch count
   over exactly that run must be its count per ``act()`` times the steps: K4 and K6 once per
   iteration (RandomSearch: K4 once, K6 never), ``draw_rows`` 1 + iterations for iCEM, once
   for RandomSearch, never elsewhere; the plain RNG (``_mirror_z``, ``_gen_z``) must see no
   CUDA tensor. One more ``act()`` of fused CEM and of fused iCEM runs under
   ``torch.profiler``: the ten device operations that take the most time, the count of K6's
   kernels (one per iteration) and the device's idle share of the ``act()`` window. The eager
   backend runs 3 steps, timed.

The line before the last two is ``{"kernels": [...]}``; then the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

FLAGSHIP = dict(dim_s=17, dim_u=6, hidden=(500, 500, 500), ensemble_size=5)
ROWS, HORIZON, STEPS, ITERS = 1000, 50, 3, 5
BIG_AGENTS = 3  # the larger batch: three agents at population ROWS
# Max |kernel - plain| over the visited states and over the rewards, each relative to
# max(1, max |plain|). f32: the kernel's FMA order differs from cuBLAS's (measured ~1e-7
# relative); bf16: one rounded activation may land 1 ulp (2^-8) apart and propagate through
# 50 steps (measured ~2e-4 relative).
TOLERANCE = {"float32": 1e-4, "bfloat16": 1e-2}
# K6's sums against the plain version's, relative to max(1, max |plain|): both sum 1000
# float32 terms, in other orders.
MOMENT_TOLERANCE = 1e-5
# draw_rows' colored draws against _mirror_z's, relative to max(1, max |plain|): the kernel
# contracts 52 terms per element with fmaf and reduces the row statistics in its own order,
# torch multiplies by the dense basis (a few ulp of z <= 2).
COLORED_DRAW_TOLERANCE = 1e-6
# K4's per-row penalty and dot against the plain version's, relative to max(1, max |plain|):
# each sums H*U = 300 float32 terms, the kernel lane-strided with a butterfly, torch otherwise.
ROW_SUM_TOLERANCE = 1e-4
# Colored draws: the kernel contracts 2F = 52 terms per element with fmaf and reduces the row
# statistics in its own order; torch multiplies by the dense [312, 300] basis. The actions (at
# most 1.3 in magnitude here) may differ by a few ulp of z <= 2, well inside 1e-4.
H100_PEAK = {"float32": 67e12, "bfloat16": 989e12}  # dense FLOP/s, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
# Operations of one clipped normal draw of the counter RNG (K3), counted as float32 operations
# at the SIMT rate, a transcendental as one: the counter (2), two keyed uniforms (14 each:
# fmix32 is 8), Box-Muller (6) and the clip (2).
RNG_OPS = 38
FUSED_TILE = 128  # ts1's logical tile in phase 3: 8 tiles of 1000 rows for 5 members
EXTRA_SLOTS = 6  # the iCEM drive's injected candidates: keep_elites 5 + the mean
COLORED_BETA = 2.0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def reward_fn(s, a, ns):
    # bench.py's flagship reward: forward progress minus an action cost.
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def rewards_from_states(s0, acts, states):
    """Undiscounted return per row from the visited states [H, rows, S]."""
    import torch

    prev = torch.cat([s0[None], states[:-1]])
    h, rows, dim_s = states.shape
    r = reward_fn(prev.reshape(-1, dim_s), acts.reshape(h * rows, -1), states.reshape(-1, dim_s))
    return r.reshape(h, rows).sum(0)


def cuda_ms(fn, reps: int) -> float:
    """ms per call of ``reps`` back-to-back calls between two events: for a kernel of a few
    microseconds, the host's time of a call (the wrapper's Python and the launch)."""
    import torch

    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20) -> float:
    """The device's ms per call: ``calls`` calls captured in a CUDA graph and replayed between
    two events (``ops/measure.py``)."""
    from blackbox_mpc_torch.ops.measure import graph_ms as measured

    return measured(fn, calls)


def flagship_params(config, device):
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
    from blackbox_mpc_torch.models.normalizer import NormalizerStats

    dp = make_learned_dynamics(config)[0](torch.Generator().manual_seed(0))
    g = np.random.default_rng(1)
    s, u = config.dim_s, config.dim_u
    stats = NormalizerStats(*(torch.as_tensor(v, dtype=torch.float32) for v in (
        g.normal(0, 1, s), g.uniform(0.5, 2, s), g.normal(0, 0.3, u), g.uniform(0.5, 1.5, u),
        g.normal(0, 0.05, s), g.uniform(0.05, 0.2, s),
    )))
    return dp.replace(stats=stats).to(device)


def mlp_work(config, rows: int, horizon: int, members: int) -> tuple[float, float]:
    """(FLOPs of the MLP over all rows and steps, bytes of its weights, biases and stats)."""
    import torch

    sizes = [config.dim_s + config.dim_u, *config.hidden, config.dim_s]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    itemsize = torch.tensor([], dtype=config.compute_dtype).element_size()
    weight_bytes = (config.ensemble_size * (macs * itemsize + 4 * sum(sizes[1:]))
                    + 4 * 6 * max(config.dim_s, config.dim_u))
    return 2.0 * macs * members * rows * horizon, weight_bytes


def least_ms(flops: float, bytes_moved: float, dtype: str) -> tuple[float, str]:
    """Least time on the card: max(bytes moved / HBM rate, operations / peak), in ms."""
    t_ops = flops / H100_PEAK[dtype] * 1e3
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dtype_name(config) -> str:
    import torch

    return "bfloat16" if config.compute_dtype == torch.bfloat16 else "float32"


def bound(config, rows: int, horizon: int, members: int) -> tuple[float, str]:
    """K2: actions and s0 in, weights in, states out; the MLP's FLOPs."""
    flops, weight_bytes = mlp_work(config, rows, horizon, members)
    bytes_moved = (4 * horizon * rows * config.dim_u + 4 * rows * config.dim_s + weight_bytes
                   + 4 * horizon * rows * config.dim_s)
    return least_ms(flops, bytes_moved, dtype_name(config))


def option_work(features, rows: int, horizon: int, dim_u: int,
                row_outputs: bool = True) -> tuple[float, float]:
    """(operations, bytes) that the options add per launch over ``rows`` candidate rows.

    Colored: per row U*2F unclipped normals in place of H*U clipped ones, 2F multiply-adds per
    element through the basis, and six operations per element for the row's mean, variance,
    division and clip; the basis is read once. Clip, injection and dot: about eight operations
    per element (clip, difference, square and add; subtract, multiply and add), their operands
    read once and K4's per-row outputs (``row_outputs``) written once.
    """
    if features is None:
        return 0.0, 0.0
    hu = horizon * dim_u
    flops, moved = 0.0, 0.0
    if features.basis is not None:
        two_f = features.basis.shape[0]
        flops += rows * ((dim_u * two_f - hu) * RNG_OPS + hu * (2 * two_f + 6))
        moved += 4 * two_f * horizon
    for operand in (features.extra, features.clip, features.gvec):
        if operand is not None:
            flops += rows * hu * 8 / 3
            moved += 4 * operand.numel()
    if row_outputs:
        moved += 4 * rows * ((features.clip is not None) + (features.gvec is not None))
    return flops, moved


def fused_bound(config, rows: int, horizon: int, members: int, agents: int,
                features=None) -> tuple[float, str]:
    """K4/K5: s0, mean, std and the seed in, weights in, states and actions out; the MLP's
    FLOPs plus the draws and the actions formed from them, plus the options' work."""
    flops, weight_bytes = mlp_work(config, rows, horizon, members)
    draws = rows * horizon * config.dim_u
    bytes_moved = (4 * agents * (config.dim_s + 2 * horizon * config.dim_u) + 4 + weight_bytes
                   + 4 * horizon * rows * (config.dim_s + config.dim_u))
    more_flops, more_bytes = option_work(features, rows, horizon, config.dim_u)
    return least_ms(flops + draws * (RNG_OPS + 2) + more_flops, bytes_moved + more_bytes,
                    dtype_name(config))


def moments_bound(weights, agents: int, hu: int, features=None,
                  dim_u: int = 1) -> tuple[float, str]:
    """K6: the weights, std (with options also mean) and the seed in, two sums out. The work
    that these weights need, since no row of weight 0 is drawn: per row of weight and column
    six operations (std * z, w * x, x * x, w * x^2 and the two adds), and one draw with the
    options' work where the row is not injected."""
    import torch

    rows = weights.numel()
    weighted = (weights != 0).cpu()
    drawn = weighted
    if features is not None and features.extra is not None:
        population = rows // agents
        fresh_rows = (population - features.extra_slots(agents)) * agents
        drawn = weighted & (torch.arange(rows) < fresh_rows)
    n_weighted, n_drawn = int(weighted.sum()), int(drawn.sum())
    bytes_moved = 4 * agents * hu + 4 * rows + 4 + 2 * 4 * agents * hu
    more_flops, more_bytes = option_work(features, n_drawn, hu // dim_u, dim_u,
                                         row_outputs=False)
    if features is not None:
        bytes_moved += 4 * agents * hu
    return least_ms(n_weighted * hu * 6 + n_drawn * hu * RNG_OPS + more_flops,
                    bytes_moved + more_bytes, "float32")


def draw_bound(rows: int, hu: int, features, dim_u: int) -> tuple[float, str]:
    """K3 on its own: the row ids and the seed in (with the colored draw the basis), z out;
    one draw per element and the colored draw's work."""
    more_flops, more_bytes = option_work(features, rows, hu // dim_u, dim_u, row_outputs=False)
    return least_ms(rows * hu * RNG_OPS + more_flops, 4 * rows + 4 + 4 * rows * hu + more_bytes,
                    "float32")


def pad_rows(x, rows: int, dim: int):
    """``x`` zero-padded along ``dim`` to ``rows`` rows, as the evaluators pad to whole tiles."""
    import torch

    pad = [0, 0] * (x.dim() - 1 - dim) + [0, rows - x.shape[dim]]
    return torch.nn.functional.pad(x, pad).contiguous()


def kernel_vs_plain(device, propagation: str, dtype: str, rows: int = ROWS) -> dict:
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    config = LearnedDynamicsConfig(**FLAGSHIP, propagation=propagation,
                                   compute_dtype=getattr(torch, dtype))
    ops = rk.make_operands(flagship_params(config, device), config)
    g = np.random.default_rng(2)
    acts = torch.as_tensor(g.uniform(-1, 1, (HORIZON, rows, config.dim_u)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.normal(0, 1, (rows, config.dim_s)), dtype=torch.float32,
                         device=device)
    member = None
    members = config.ensemble_size
    tile = rk.tile_rows(propagation == "ts1")
    if propagation == "ts1":
        # rows / E rows per member: whole tiles, so the member-major blocks need no padding.
        if rows % (config.ensemble_size * tile):
            raise AssertionError(f"ts1 case needs rows a multiple of {config.ensemble_size * tile}")
        member = torch.arange(config.ensemble_size, dtype=torch.int32, device=device)
        member = member.repeat_interleave(rows // config.ensemble_size // tile)
        members = 1
    rows_pad = -(-rows // tile) * tile
    acts_pad, s0_pad = pad_rows(acts, rows_pad, 1), pad_rows(s0, rows_pad, 0)

    def kernel():
        return rk.rollout_states(config, ops, acts_pad, s0_pad, member)

    def plain():
        return rk.rollout_states_plain(config, ops, acts, s0, member)

    states, ref_states = kernel()[:, :rows], plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(states).all()):
        raise AssertionError(f"{propagation}/{dtype}: kernel states not finite")
    got, ref = rewards_from_states(s0, acts, states), rewards_from_states(s0, acts, ref_states)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    state_err = float((states - ref_states).abs().max())
    state_scale = max(1.0, float(ref_states.abs().max()))
    bound_ms, bound_by = bound(config, rows, HORIZON, members)
    res = {
        "case": f"{propagation}/{dtype}" + ("" if rows == ROWS else f" rows={rows}"),
        "rows": rows, "rows_launched": rows_pad, **rk.kernel_occupancy(config, rows_pad),
        "max_abs_err": err, "max_rel_err": err / scale, "tolerance_rel": TOLERANCE[dtype],
        "state_max_abs_err": state_err, "state_max_rel_err": state_err / state_scale,
        "ms": cuda_ms(kernel, 5), "plain_ms": cuda_ms(plain, 3),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(json.dumps(res), flush=True)
    if state_err > TOLERANCE[dtype] * state_scale:
        raise AssertionError(f"{propagation}/{dtype}: kernel vs plain states {state_err} > "
                             f"{TOLERANCE[dtype]} * {state_scale}")
    if err > TOLERANCE[dtype] * scale:
        raise AssertionError(f"{propagation}/{dtype}: kernel vs plain rewards {err} > "
                             f"{TOLERANCE[dtype]} * {scale}")
    return res


def flagship_features(device, options: str, mean=None, std=None):
    """``Features`` of the flagship shape (one agent, H*U = 300) for an option set: "icem"
    (colored noise and EXTRA_SLOTS injected candidates in a population of ROWS), "mppi" (a
    bounds clip at +/-0.5, which clips a visible share of mean +/-0.3 + std 0.2-0.5 * z, and
    the dot against mean / variance), "uniform", or "clip"."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc

    dim_u = FLAGSHIP["dim_u"]
    g = np.random.default_rng(7)
    if options == "icem":
        basis2 = torch.as_tensor(fc._colored_basis2(HORIZON, dim_u, COLORED_BETA), device=device)
        extra = torch.as_tensor(g.uniform(-1, 1, (EXTRA_SLOTS, HORIZON * dim_u)),
                                dtype=torch.float32, device=device)
        return fc.Features(basis2=basis2, extra=extra, population=ROWS,
                           basis=basis2[:2 * (HORIZON // 2 + 1), ::dim_u].contiguous())
    if options == "uniform":
        return fc.Features(sampling="uniform")
    clip = torch.tensor([[-0.5] * dim_u, [0.5] * dim_u], device=device)
    if options == "clip":
        return fc.Features(clip=clip)
    return fc.Features(clip=clip, gvec=(mean / (std * std)).contiguous())


def fused_closures(device, propagation: str, dtype: str, streamed: bool = False,
                   options: str | None = None, agents: int = 1) -> dict:
    """The flagship inputs of K4 (or K5), for ``agents`` agents at population ROWS, and the
    closures that run its kernel (on the rows padded to its tile, cut back to the rows asked
    for) and its plain version on them."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    config = LearnedDynamicsConfig(**FLAGSHIP, propagation=propagation,
                                   compute_dtype=getattr(torch, dtype))
    ops = rk.make_operands(flagship_params(config, device), config)
    g = np.random.default_rng(4)
    hu = HORIZON * config.dim_u
    rows = ROWS * agents
    s0 = torch.as_tensor(g.normal(0, 1, (agents, config.dim_s)), dtype=torch.float32,
                         device=device)
    # The flagship's first CEM iteration samples around the midpoint with std 0.5.
    mean = torch.as_tensor(g.uniform(-0.3, 0.3, (agents, hu)), dtype=torch.float32,
                           device=device)
    std = torch.as_tensor(g.uniform(0.2, 0.5, (agents, hu)), dtype=torch.float32, device=device)
    seed = torch.tensor([1234567891], dtype=torch.int32, device=device)
    tile = rk.tile_rows(propagation == "ts1")
    rows_pad = -(-rows // tile) * tile
    member, member_tile, members = None, tile, config.ensemble_size
    if propagation == "ts1":
        rr, _ = fc.make_fused_cem_kernels(config, reward_fn, horizon=HORIZON, agents=1,
                                          population=ROWS, tile=FUSED_TILE)
        member = torch.as_tensor(rr.tile_member_ids, device=device)
        member_tile, members = FUSED_TILE, 1
    features = flagship_features(device, options, mean, std) if options else None
    more = {} if streamed else {"features": features}

    def launch():
        if streamed:
            return fc.fused_rollout_streamed(config, ops, s0, mean, std, seed, rows_pad, member,
                                             member_tile)
        return fc.fused_rollout(config, ops, s0, mean, std, seed, rows_pad, member, member_tile,
                                **more)

    def kernel():
        # states, actions [H, rows, .], then with options penalty and dots [rows] or None
        out = launch()
        return tuple(None if o is None else (o[:, :rows] if o.dim() == 3 else o[:rows])
                     for o in out)

    def plain():
        return fc.fused_rollout_plain(config, ops, s0, mean, std, seed, rows, member,
                                      member_tile, streamed=streamed, **more)

    case = f"{'K5' if streamed else 'K4'} {propagation}/{dtype}"
    if options:
        case += f" {options}"
    if agents > 1:
        case += f" rows={rows}"
    occupancy = fc.fused_occupancy(config, rows_pad, HORIZON, streamed=streamed,
                                   features=features)
    return dict(case=case, kernel=kernel, launch=launch, plain=plain, config=config, ops=ops,
                s0=s0, mean=mean, std=std, seed=seed, features=features,
                member_tile=member_tile, members=members, rows=rows, rows_pad=rows_pad,
                agents=agents, occupancy=occupancy)


def retime_in_turns(device, rounds: int = 3) -> None:
    """K4 (mean/f32) plain and with each option set, and K5, timed again in turns, so that no
    case owes its time to its place in the run: the median and range over ``rounds``."""
    import numpy as np

    cases = [fused_closures(device, "mean", "float32", options=o)
             for o in (None, "icem", "mppi", "uniform")]
    cases.append(fused_closures(device, "mean", "float32", streamed=True))
    times = {c["case"]: [] for c in cases}
    for _ in range(rounds):
        for c in cases:
            times[c["case"]].append(cuda_ms(c["launch"], 5))
    print(json.dumps({"retimed_in_turns_ms": {
        case: {"median": float(np.median(t)), "min": min(t), "max": max(t)}
        for case, t in times.items()}}), flush=True)


def fused_vs_plain(device, propagation: str, dtype: str, streamed: bool = False,
                   options: str | None = None, agents: int = 1) -> dict:
    """K4 (or K5) against its plain version: the actions rolled out, the visited states and
    the rewards; with ``options`` (see :func:`flagship_features`) also the penalty, which the
    rewards then include, and the dots."""
    import torch

    closures = fused_closures(device, propagation, dtype, streamed, options, agents)
    case, kernel, plain, config, s0, features, member_tile, members, rows = (
        closures[k] for k in ("case", "kernel", "plain", "config", "s0", "features",
                              "member_tile", "members", "rows"))
    out, ref_out = kernel(), plain()
    (states, actions), (ref_states, ref_actions) = out[:2], ref_out[:2]
    torch.cuda.synchronize()
    if not bool(torch.isfinite(states).all() and torch.isfinite(actions).all()):
        raise AssertionError(f"{case}: kernel states or actions not finite")
    s0_rows = s0.repeat(ROWS, 1)  # row r starts at s0[r % agents]
    got = rewards_from_states(s0_rows, actions, states)
    ref = rewards_from_states(s0_rows, ref_actions, ref_states)
    compared = [("actions", actions, ref_actions, TOLERANCE["float32"]),
                ("states", states, ref_states, TOLERANCE[dtype])]
    clipped_share = None
    if features is not None and features.clip is not None:
        got, ref = got - out[2], ref - ref_out[2]  # rewards = evaluate(clipped) - penalty
        compared.append(("penalty", out[2], ref_out[2], ROW_SUM_TOLERANCE))
        at_bound = (actions == features.clip[0]) | (actions == features.clip[1])
        clipped_share = float(at_bound.float().mean())
        if not 0.02 < clipped_share < 0.9:
            raise AssertionError(f"{case}: {clipped_share:.3f} of the draws clip, not a "
                                 "visible share")
    if features is not None and features.gvec is not None:
        compared.append(("dots", out[3], ref_out[3], ROW_SUM_TOLERANCE))
    if features is not None and features.extra is not None:
        injected = actions[:, rows - EXTRA_SLOTS:].transpose(0, 1).reshape(EXTRA_SLOTS, -1)
        if not torch.equal(injected, features.extra):
            raise AssertionError(f"{case}: the injected rows did not roll out `extra`")
    compared.append(("rewards", got, ref, TOLERANCE[dtype]))
    errs = {}
    for what, a, b, tol in compared:
        err, scale = float((a - b).abs().max()), max(1.0, float(b.abs().max()))
        errs[what] = (err, scale, tol)
    bound_ms, bound_by = fused_bound(config, rows, HORIZON, members, agents, features)
    res = {
        "case": case, "member_tile": member_tile, "rows": rows,
        "rows_launched": closures["rows_pad"], **closures["occupancy"],
        **({} if clipped_share is None else {"clipped_share": clipped_share}),
        **{f"{what}_max_abs_err": e for what, (e, _, _) in errs.items()},
        **{f"{what}_max_rel_err": e / sc for what, (e, sc, _) in errs.items()},
        "max_abs_err": errs["rewards"][0], "tolerance_rel": TOLERANCE[dtype],
        "ms": cuda_ms(closures["launch"], 5), "plain_ms": cuda_ms(plain, 3),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(json.dumps(res), flush=True)
    for what, (err, scale, tol) in errs.items():
        if err > tol * scale:
            raise AssertionError(f"{case}: kernel vs plain {what} {err} > {tol} * {scale}")
    return res


def draw_features(device, kind: str):
    """``Features`` of a draw at the flagship: "white", "uniform" or "colored" (beta 2, the
    dense basis for the plain version and its [2F, H] block for the kernels)."""
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc

    if kind == "uniform":
        return fc.Features(sampling="uniform")
    if kind == "white":
        return fc.Features()
    dim_u = FLAGSHIP["dim_u"]
    basis2 = torch.as_tensor(fc._colored_basis2(HORIZON, dim_u, COLORED_BETA), device=device)
    return fc.Features(basis2=basis2, basis=fc._basis_block(basis2, dim_u))


def bits(x):
    import torch

    return x.contiguous().view(torch.int32)


def draw_rows_vs_plain(device) -> dict:
    """K3 on its own (``draw_rows``) against its plain version ``_mirror_z`` on the card, bit
    for bit (white, uniform) or within COLORED_DRAW_TOLERANCE (colored), at rows far apart; and
    against K4 itself, bit for bit: at mean 0 and std 1 the actions K4 rolls out are its draws,
    here at rows of the first, a middle and the last tile (the last holding the grid's padding
    rows). Times the iCEM shape (5 carried elites, colored) and the RandomSearch shape (one
    argmax row, uniform): the host's and the device's time of a call. Returns the iCEM case."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    dim_u = FLAGSHIP["dim_u"]
    hu = HORIZON * dim_u
    seed = torch.tensor([1234567891], dtype=torch.int32, device=device)
    config = LearnedDynamicsConfig(**FLAGSHIP, propagation="mean")
    ops = rk.make_operands(flagship_params(config, device), config)
    tile = rk.TILE_MEAN
    rows_pad = -(-ROWS // tile) * tile
    s0 = torch.zeros((1, config.dim_s), device=device)
    mean, std = torch.zeros((1, hu), device=device), torch.ones((1, hu), device=device)
    at = torch.tensor([0, 1, tile - 1, tile, ROWS // 2 + 17, rows_pad - tile, ROWS - 1,
                       rows_pad - 1], dtype=torch.int32, device=device)
    far = torch.as_tensor(np.random.default_rng(8).integers(0, 2_000_000, 64), device=device)
    cases = {}
    for kind in ("white", "uniform", "colored"):
        f = draw_features(device, kind)
        out = fc.fused_rollout(config, ops, s0, mean, std, seed, rows_pad, None, tile,
                               features=None if kind == "white" else f)
        k4 = out[1][:, at.long()].transpose(0, 1).reshape(len(at), hu)
        got = fc.draw_rows(seed, at, hu, f.basis, f.sampling)
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(k4)):
            raise AssertionError(f"draw_rows {kind}: not K4's draws, max abs difference "
                                 f"{float((got - k4).abs().max())}")
        got = fc.draw_rows(seed, far, hu, f.basis, f.sampling)
        ref = fc._mirror_z(seed, far, hu, f.basis2, f.sampling)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        if kind == "colored" and err > COLORED_DRAW_TOLERANCE * scale:
            raise AssertionError(f"draw_rows colored vs plain {err} > "
                                 f"{COLORED_DRAW_TOLERANCE} * {scale}")
        if kind != "colored" and not torch.equal(bits(got), bits(ref)):
            raise AssertionError(f"draw_rows {kind} vs plain: not bit for bit ({err})")
        cases[kind] = err
    print(json.dumps({"draw_rows_vs_k4": "bit for bit", "rows": at.tolist(),
                      "vs_plain_max_abs_err": cases,
                      "colored_tolerance_rel": COLORED_DRAW_TOLERANCE}), flush=True)
    shapes = {"iCEM": (torch.tensor([3, 150, 402, 777, 998], device=device), "colored"),
              "RandomSearch": (torch.tensor([613], device=device), "uniform")}
    timed = {}
    for label, (rows, kind) in shapes.items():
        f = draw_features(device, kind)

        def kernel(rows=rows, f=f):
            return fc.draw_rows(seed, rows, hu, f.basis, f.sampling)

        def plain(rows=rows, f=f):
            return fc._mirror_z(seed, rows, hu, f.basis2, f.sampling)

        err = float((kernel() - plain()).abs().max())
        bound_ms, bound_by = draw_bound(len(rows), hu, f, dim_u)
        timed[label] = {"case": f"draw_rows {label} ({len(rows)} rows, {kind})",
                        "max_abs_err": err, "ms": graph_ms(kernel), "host_ms": cuda_ms(kernel, 20),
                        "plain_ms": cuda_ms(plain, 5), "bound_ms": bound_ms,
                        "bound_by": bound_by}
        print(json.dumps(timed[label]), flush=True)
    return timed["iCEM"]


def moment_weights(kind: str, rng):
    """Weights [ROWS] of one agent: a 50-elite 0/1 mask, softmax weights, sep-CMA's log-rank
    weights scattered by a random ranking, all zeros, or one nonzero row."""
    import numpy as np

    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.solvers import cma_es as cma

    w = np.zeros(ROWS, np.float32)
    if kind == "elite_mask":
        w[rng.choice(ROWS, 50, replace=False)] = 1.0
    elif kind == "softmax":
        e = np.exp(rng.normal(0, 3, ROWS))
        w = (e / e.sum()).astype(np.float32)
    elif kind == "logrank":
        constants = cma.cma_constants(cma.CMAESConfig(diagonal=True),
                                      Bounds.of(-1.0, 1.0, dim=FLAGSHIP["dim_u"]), HORIZON,
                                      ROWS, 50)
        w[rng.permutation(ROWS)] = constants.weights
    elif kind == "single":
        w[rng.integers(ROWS)] = 0.75
    elif kind != "zeros":
        raise ValueError(kind)
    return w


def moments_vs_plain(device, weights: str, options: str | None = None) -> dict:
    """K6 against its plain version, and against itself: two runs, the same bits. ``weights``
    names a kind of :func:`moment_weights`, ``options`` a set of :func:`flagship_features`."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc

    g = np.random.default_rng(5)
    hu = HORIZON * FLAGSHIP["dim_u"]
    std = torch.as_tensor(g.uniform(0.2, 0.5, (1, hu)), dtype=torch.float32, device=device)
    seed = torch.tensor([987654321], dtype=torch.int32, device=device)
    w = torch.as_tensor(moment_weights(weights, g), device=device)
    mean = torch.as_tensor(g.uniform(-0.3, 0.3, (1, hu)), dtype=torch.float32, device=device)
    features = flagship_features(device, options) if options else None
    if options:
        weights = f"{weights} {options}"

    def kernel():
        return fc.elite_moments(std, w, seed, mean, features)

    def plain():
        return fc.elite_moments_plain(std, w, seed, mean, features)

    first, second, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(first, second)):
        raise AssertionError(f"K6 {weights}: two runs differ")
    err = max(float((a - b).abs().max()) for a, b in zip(first, ref))
    scale = max(1.0, max(float(b.abs().max()) for b in ref))
    bound_ms, bound_by = moments_bound(w, 1, hu, features, FLAGSHIP["dim_u"])
    res = {"case": f"K6 {weights}", "weighted_rows": int((w != 0).sum()), "max_abs_err": err,
           "max_rel_err": err / scale, "tolerance_rel": MOMENT_TOLERANCE,
           "repeat_bitwise": True, "ms": graph_ms(kernel), "host_ms": cuda_ms(kernel, 20),
           "plain_ms": cuda_ms(plain, 5), "bound_ms": bound_ms, "bound_by": bound_by}
    print(json.dumps(res), flush=True)
    if err > MOMENT_TOLERANCE * scale:
        raise AssertionError(f"K6 {weights}: kernel vs plain {err} > {MOMENT_TOLERANCE} * {scale}")
    return res


def moments_see_fused_rollout(device) -> None:
    """K6 regenerates K4's bits: with one weight of 1, the centered sum is that row's rolled-out
    action less the mean, to the last bit, for the clip and for colored + clip (with the clip,
    K4 and K6 both center as clipped - mean)."""
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc

    for options in ("clip", "colored+clip"):
        closures = fused_closures(device, "mean", "float32", options="clip")
        features = closures["features"]
        if options == "colored+clip":
            colored = draw_features(device, "colored")
            features = fc.Features(basis2=colored.basis2, basis=colored.basis,
                                   clip=features.clip)
        mean, std, seed = closures["mean"], closures["std"], closures["seed"]
        actions = fc.fused_rollout(closures["config"], closures["ops"], closures["s0"], mean,
                                   std, seed, closures["rows_pad"], features=features)[1]
        for row in (0, ROWS // 2 + 17, ROWS - 1):
            w = torch.zeros(ROWS, device=device)
            w[row] = 1.0
            csum, _ = fc.elite_moments(std, w, seed, mean, features)
            if not torch.equal(bits(csum[0]), bits(actions[:, row].reshape(-1) - mean[0])):
                raise AssertionError(f"K6 {options}: row {row} is not K4's")
    print(json.dumps({"k6_regenerates_k4": "bit for bit", "options": ["clip", "colored+clip"],
                      "rows": [0, ROWS // 2 + 17, ROWS - 1]}), flush=True)


def small_reference(device) -> None:
    """Kernel evaluator vs the eager evaluator, and the fused kernels vs their plain versions,
    on a small input (f32, rtol/atol 1e-4; moments 1e-5)."""
    from functools import partial

    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
    from blackbox_mpc_torch.ops.fused_cem import make_fused_cem_kernels
    from blackbox_mpc_torch.ops.rollout_kernel import make_rollout_kernel_evaluator
    from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

    g = np.random.default_rng(3)
    for propagation in ("mean", "ts1"):
        config = LearnedDynamicsConfig(dim_s=17, dim_u=6, hidden=(64, 64), ensemble_size=5,
                                       propagation=propagation)
        dp = flagship_params(config, device)
        dyn = make_learned_dynamics(config)[1]
        s0 = torch.as_tensor(g.normal(0, 1, (2, 17)), dtype=torch.float32, device=device)
        acts = torch.as_tensor(g.uniform(-1, 1, (35, 2, 10, 6)), dtype=torch.float32,
                               device=device)
        got = make_rollout_kernel_evaluator(config, reward_fn, discount=0.95, device=device)(
            dp, s0, acts)
        ref = make_trajectory_evaluator(partial(dyn, dp), reward_fn, discount=0.95,
                                        device=device)(s0, acts)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        print(json.dumps({"small_reference": propagation, "shape": list(got.shape),
                          "max_abs_err": float((got - ref).abs().max())}), flush=True)
        # The fused kernels against the same closures on CPU tensors (the plain versions,
        # which tests/test_torch_fused_cem.py holds against the JAX package).
        rr, em = make_fused_cem_kernels(config, reward_fn, horizon=10, agents=2,
                                        population=35, tile=8)
        mean = torch.as_tensor(g.uniform(-0.5, 0.5, (2, 10, 6)), dtype=torch.float32,
                               device=device)
        std = torch.as_tensor(g.uniform(0.1, 0.5, (2, 10, 6)), dtype=torch.float32,
                              device=device)
        got = rr(dp, s0, mean, std, 42)
        ref = rr(dp.to("cpu"), s0.cpu(), mean.cpu(), std.cpu(), 42)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
        mask = (got >= got.topk(5, dim=0).values[-1]).float()
        for a, b in zip(em(mean, std, 42, mask), em(mean.cpu(), std.cpu(), 42, mask.cpu())):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        print(json.dumps({"small_reference": f"fused {propagation}", "shape": list(got.shape),
                          "max_abs_err": float((got.cpu() - ref).abs().max())}), flush=True)
        # The same with each fused solver's option set: iCEM, MPPI, PI2 with colored noise,
        # RandomSearch.
        box = (np.full(6, -0.4, np.float32), np.full(6, 0.45, np.float32))
        for name, options in (
            ("icem", dict(colored_noise_beta=COLORED_BETA, extra_slots=3)),
            ("mppi", dict(clip_bounds=box, aux_dot=True)),
            ("pi2 colored", dict(clip_bounds=box, colored_noise_beta=1.0)),
            ("uniform", dict(sampling="uniform")),
        ):
            rr, em = make_fused_cem_kernels(config, reward_fn, horizon=10, agents=2,
                                            population=35, tile=8, **options)
            both, rollout_only = {}, {}
            if options.get("extra_slots"):
                both["extra"] = torch.as_tensor(g.uniform(-1, 1, (3, 2, 60)),
                                                dtype=torch.float32, device=device)
            if options.get("aux_dot"):
                rollout_only["gvec"] = torch.as_tensor(g.normal(0, 1, (2, 60)),
                                                       dtype=torch.float32, device=device)
            on_cpu = lambda named: {k: v.cpu() for k, v in named.items()}  # noqa: E731
            got = rr(dp, s0, mean, std, 42, **both, **rollout_only)
            ref = rr(dp.to("cpu"), s0.cpu(), mean.cpu(), std.cpu(), 42, **on_cpu(both),
                     **on_cpu(rollout_only))
            if options.get("aux_dot"):
                torch.testing.assert_close(got[1].cpu(), ref[1], rtol=1e-4, atol=1e-4)
                got, ref = got[0], ref[0]
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
            weights = torch.softmax(got, dim=0)
            for a, b in zip(em(mean, std, 42, weights, **both),
                            em(mean.cpu(), std.cpu(), 42, weights.cpu(), **on_cpu(both))):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
            print(json.dumps({"small_reference": f"fused {propagation} {name}",
                              "shape": list(got.shape),
                              "max_abs_err": float((got.cpu() - ref).abs().max())}), flush=True)


def launch_counters() -> dict:
    """Every kernel wrapper with a launch count, by the name the kernels line gives it."""
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    return {"rollout_states": rk.rollout_states, "fused_rollout": fc.fused_rollout,
            "fused_rollout_streamed": fc.fused_rollout_streamed,
            "elite_moments": fc.elite_moments, "draw_rows": fc.draw_rows}


@contextlib.contextmanager
def plain_rng_on_cuda():
    """Counts the calls of the plain RNG (``_mirror_z``, ``_gen_z``) that get a CUDA tensor,
    while the context lasts: on the card's main path there must be none."""
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc

    calls = {"_mirror_z": 0, "_gen_z": 0}
    originals = {name: getattr(fc, name) for name in calls}

    def counting(name):
        def call(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda for a in (*args, *kwargs.values())):
                calls[name] += 1
            return originals[name](*args, **kwargs)
        return call

    for name in calls:
        setattr(fc, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(fc, name, fn)


# The kernels each backend's act() launches, and how often; all others, never.
BACKEND_KERNELS = {"kernel": {"rollout_states": ITERS},
                   "fused": {"fused_rollout": ITERS, "elite_moments": ITERS}, "eager": {}}
# The fused family at the flagship settings, by the label of its drive: (registry name, solver
# kwargs, launches per act() by kernel).
FUSED_FAMILY = {
    "fused iCEM": ("CEM", dict(num_elite=50, max_iterations=ITERS,
                               colored_noise_beta=COLORED_BETA, keep_elites=EXTRA_SLOTS - 1,
                               mean_as_candidate=True, execute_best=True),
                   {**BACKEND_KERNELS["fused"], "draw_rows": 1 + ITERS}),
    "fused MPPI": ("MPPI", dict(max_iterations=ITERS), BACKEND_KERNELS["fused"]),
    "fused RandomSearch": ("RandomSearch", dict(), {"fused_rollout": 1, "draw_rows": 1}),
    "fused CMA-ES": ("CMA-ES", dict(num_elite=50, max_iterations=ITERS, diagonal=True),
                     BACKEND_KERNELS["fused"]),
}
# The drives of which one more act() is traced.
TRACED = ("fused", "fused iCEM")


def trace_act(policy, obs, label: str) -> dict:
    """One ``act()`` under ``torch.profiler``: the ten device operations that take the most
    time, the launches of K6's and K3's kernels, the share of the ``act()`` window (the host's
    range around it, which ends in the copy of the action to the host) in which the device ran
    nothing, and the longest stretches of it, each with its start in the window and the device
    operation that ended it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("act"):
            policy.act(obs)
    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == "act" and e.device_type == DeviceType.CPU)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        raise AssertionError(f"{label}: the profiler saw no device activity in act()")
    busy, reached = 0.0, window.start
    by_name: dict = {}
    gaps = []  # (idle us, its start from the window's, the device operation after it)
    for start, end, name in spans:
        lo, hi = min(max(start, reached), window.end), min(end, window.end)
        if lo > reached:
            gaps.append((lo - reached, reached - window.start, name[:60]))
        if hi > lo:
            busy += hi - lo
        reached = max(reached, hi)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    gaps.append((window.end - reached, reached - window.start, "(end of act)"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"trace": label, "act_window_us": window.end - window.start, "device_busy_us": busy,
           "device_idle_share": 1.0 - busy / (window.end - window.start),
           "idle_gaps_us": [{"us": us, "at_us": at, "before": name}
                            for us, at, name in sorted(gaps, reverse=True)[:6]],
           "device_ops": len(spans),
           "k6_kernels": sum(n for name, (_, n) in by_name.items() if "moments_" in name),
           "draw_rows_kernels": sum(n for name, (_, n) in by_name.items()
                                    if "draw_rows_kernel" in name),
           "top_device_ops_us": [{"name": name[:90], "us": t, "count": n}
                                 for name, (t, n) in top]}
    print(json.dumps(res), flush=True)
    return res


def drive_policy(device, backend: str, steps: int, label: str | None = None) -> dict:
    """``steps`` closed-loop ``act()`` calls after a warm-up. ``label`` names a drive of
    FUSED_FAMILY; without it the solver is the flagship CEM on ``backend``. A drive in TRACED
    then acts once more under the profiler, which must see one K6 kernel per iteration."""
    import numpy as np

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    solver_name, solver_kwargs, per_act = (
        FUSED_FAMILY[label] if label
        else ("CEM", dict(num_elite=50, max_iterations=ITERS), BACKEND_KERNELS[backend]))
    label = label or backend
    config = LearnedDynamicsConfig(**FLAGSHIP, propagation="mean")
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(flagship_params(config, device))
    policy = MPCPolicy(
        BoxSpace.of(-1.0, 1.0, dim=6), reward_fn, handler, solver_name=solver_name,
        rollout_backend=backend, planning_horizon=HORIZON, population=ROWS, seed=0,
        device=device, **solver_kwargs,
    )
    obs = np.zeros(17, np.float32)
    policy.act(obs)  # warm-up: first-use costs (kernel load, cuBLAS handles)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    times = []
    with plain_rng_on_cuda() as plain_calls:
        for t in range(steps):
            t0 = time.perf_counter()
            action, obs, reward = policy.act(obs, t)  # returns host arrays: synchronised
            times.append((time.perf_counter() - t0) * 1e3)
            if not (np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)):
                raise AssertionError(f"{label}: action out of bounds or not finite: {action}")
            if not (np.all(np.isfinite(obs)) and np.isfinite(reward)):
                raise AssertionError(f"{label}: predicted next obs/reward not finite")
    launches = {name: wrapper.launches for name, wrapper in counters.items()}
    expected = {name: steps * per_act.get(name, 0) for name in counters}
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the plain RNG ran on CUDA tensors: {plain_calls}")
    res = {"policy": label, "solver": solver_name, "steps": steps, "launches": launches,
           "plain_rng_calls_on_cuda": plain_calls, "act_ms": times,
           "act_ms_median": float(np.median(times)),
           "last_action": [float(a) for a in action], "last_predicted_reward": float(reward)}
    print(json.dumps(res), flush=True)
    if label in TRACED:
        res["trace"] = trace_act(policy, obs, label)
        iterations = per_act["elite_moments"]
        if res["trace"]["k6_kernels"] != iterations:
            raise AssertionError(f"{label}: {res['trace']['k6_kernels']} K6 kernels in one "
                                 f"act(), expected one per iteration ({iterations})")
        if res["trace"]["draw_rows_kernels"] != per_act.get("draw_rows", 0):
            raise AssertionError(f"{label}: {res['trace']['draw_rows_kernels']} draw_rows "
                                 f"kernels in one act(), expected {per_act.get('draw_rows', 0)}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Fails here when run outside the repository.
    from blackbox_mpc_torch.core.device import resolve_device
    from blackbox_mpc_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(None)
    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build("rollout", "fused_cem")
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "compiled": sorted(name for name, log in logs.items() if log)}), flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"{name}: {line.strip()}")

    cases = [kernel_vs_plain(device, p, d)
             for p, d in (("mean", "float32"), ("mean", "bfloat16"), ("ts1", "float32"))]
    fused = [fused_vs_plain(device, p, d)
             for p, d in (("mean", "float32"), ("mean", "bfloat16"), ("ts1", "float32"))]
    streamed = fused_vs_plain(device, "mean", "float32", streamed=True)
    kernel_vs_plain(device, "mean", "float32", rows=ROWS * BIG_AGENTS)
    fused_vs_plain(device, "mean", "float32", agents=BIG_AGENTS)
    for options in ("icem", "mppi", "uniform"):
        fused_vs_plain(device, "mean", "float32", options=options)
    retime_in_turns(device)
    tiny = torch.zeros(1, device=device)  # the reference for K3's and K6's device times
    print(json.dumps({"empty_launch_ms": graph_ms(lambda: tiny.add_(1.0))}), flush=True)
    draws = draw_rows_vs_plain(device)
    moments = [moments_vs_plain(device, w)
               for w in ("elite_mask", "softmax", "logrank", "zeros", "single")]
    for weights, options in (("elite_mask", "icem"), ("softmax", "icem"), ("single", "icem"),
                             ("softmax", "clip"), ("logrank", "clip"), ("zeros", "clip")):
        moments_vs_plain(device, weights, options)
    moments_see_fused_rollout(device)
    small_reference(device)
    kernel_run = drive_policy(device, "kernel", STEPS)
    fused_run = drive_policy(device, "fused", STEPS)
    family = {label: drive_policy(device, "fused", STEPS, label) for label in FUSED_FAMILY}
    drive_policy(device, "eager", 3)
    print(json.dumps({"act_ms_median": {
        "kernel": kernel_run["act_ms_median"], "fused": fused_run["act_ms_median"],
        **{label: run["act_ms_median"] for label, run in family.items()}}}), flush=True)

    # The first case of each kernel is mean/f32 (K6: the 50-elite mask; draw_rows: the iCEM
    # shape), as the policy ran. K6's and draw_rows' ms is the device's, host_ms the host's.
    entries = [
        ("rollout_states", "rollout.cu", "pallas_rollout.py:73", kernel_run, cases[0]),
        ("fused_rollout", "fused_cem.cu", "pallas_cem.py:338", fused_run, fused[0]),
        ("fused_rollout_streamed", "fused_cem.cu", "pallas_cem.py:404", fused_run, streamed),
        ("elite_moments", "fused_cem.cu", "pallas_cem.py:485", fused_run, moments[0]),
        ("draw_rows", "fused_cem.cu", "pallas_cem.py:168", family["fused iCEM"], draws),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"blackbox_mpc_torch/ops/csrc/{source}",
        "replaces": f"blackbox_mpc_tpu/ops/{replaces}",
        "launches": run["launches"][name],
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": None,
        **({"host_ms": case["host_ms"]} if "host_ms" in case else {}),
    } for name, source, replaces, run, case in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
