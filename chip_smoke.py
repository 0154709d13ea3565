"""Smoke test of the PyTorch/CUDA port (blackbox_mpc_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package. Phases, each fatal on failure:

1. device: print the card's name and power limit (``nvidia-smi``); no CUDA -> exit 2.
2. build: compile the port's CUDA sources with ``nvcc``, one process per source, together.
3. kernel vs plain at the flagship shape (rows=1000, H=50, a 5-member 3x500 tanh ensemble,
   S=17, U=6, seeded random weights, non-trivial normalizer stats), each kernel against its
   plain PyTorch version on the same inputs, with the times of both and the analytic bound:
   - the rollout kernel (K2 with K1 inside) for mean/f32, mean/bf16 and ts1/f32: the whole
     visited-state tensor [H, rows, S] and the rewards summed from it; and its ts_inf
     instantiation at the PETS cell's shape instead (``ops/measure.py::pets_launch``: a
     5-member 4x200 swish Gaussian ensemble, S=18, U=6, learned bounds, 10 000 particle rows
     in member-major blocks, H=30, the noise an input), within the same 1e-4;
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
   - the RSSM core's block layer on the tensor cores (``ops/block_gemm.py``, split-operand
     3xTF32 ``wgmma``) at DreamerV3 size200m's two block shapes, 8 groups of 4096 -> 1024 and
     of 1024 -> 3072, at 1, 104 and 1000 rows: its largest error against a float64 product of
     the same inputs at most 4x that of ``torch.baddbmm``'s float32 one, two launches and a
     captured graph's replay bit for bit; one line gives each shape's device ms a launch (20
     in a graph) at 1000 rows beside its bound at the 3xTF32 ceiling (165 TFLOP/s) and at
     the float32 SIMT peak (67), and ``torch.baddbmm``'s ms as ``library_ms`` (a yardstick;
     the port's path never calls it there). ``python3 chip_smoke.py --block-gemm`` runs it
     alone, with phase 5's RSSM drive.
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
   CUDA tensor. One more ``act()`` of fused CEM, fused iCEM and fused CMA-ES runs under
   ``torch.profiler``: the ten device operations that take the most time, the count of K4's
   and K6's kernels (one each per iteration: the trace must record every launch, so that its
   idle share reads a whole trace, and a trace that lost one is made again, at most 3 times in
   all; so too in phases 6, 8 B and 10), the device's idle share of the ``act()`` window and
   the host's ``cudaStreamSynchronize`` calls, which must be 2 (the observation in, the action
   out) for fused CEM and at most 2 for the others. Fused CEM is also traced, and timed in
   turns, with the elite mask written from a Python scalar (the former scatter, which made
   the host wait for K4 in every iteration), beside the scatter from a device source. The
   eager backend runs 3 steps, timed. DreamerV3's RSSM at size200m, under the RSSM cell's CEM
   (1000 x 10 iterations, H=12) on ``"auto"`` (eager, graphed), acts 3 times: the first (eager
   evaluation, capture), one with the launch counters zeroed just before it, whose host
   launches of the block kernel must be 4 (the filter's and the lookahead's core steps; the
   first ``act()``'s 52), and one traced, whose device launches of it must be 244 (2 a core
   step); its line gives the ``act()``'s ms, the weights' and their pack's bytes and the
   card's peak over the ``act()``s alone. V-JEPA 2-AC at the published widths (a ViT-g
   encoder, the 300M predictor), under its cell's CEM (128 x 10 elites x 3 iterations, H=2)
   toward a seeded goal image on ``"auto"`` (eager, graphed), acts 4 times: the first (eager
   evaluation, capture), two timed, and one traced, whose host must wait twice, whose
   evaluations must all replay, and whose device must run one attention kernel of
   ``port_bench/metrics/models.attention_share.py``'s names per attention call (208: 40
   encoder blocks, 24 predictor blocks a frame, 7 frames); its line gives the ``act()``s' ms,
   the cache's bytes (6.49 GB: 24 blocks' keys and values of 128 rows of one 258-token
   frame), the weights' bytes and the card's peak over the ``act()``s. ``python3
   chip_smoke.py --vjepa2`` runs it alone.
6. MBRL loop: ``learn_dynamics_iteratively_w_mpc`` on the native pendulum (2 envs, episodes of
   50 steps; S=3, U=1) with the flagship ensemble (3x500 tanh, 5 members, mean, f32) and CEM
   (H=50, population 1000, 50 elites, 5 iterations): one random bootstrap rollout, then 2
   refinements of one MPC rollout each, 5 epochs of batch 128 per ``train()``, on
   ``"kernel"`` and on ``"fused"``. Gates: after every ``train()`` K2 (against the eager
   evaluator) and K4 (against its plain version) on the trained weights and fitted stats,
   1e-4 relative; the policy's evaluator packs the weights once at its first ``act()`` and
   once after each ``train()`` that precedes an ``act()``; K2, or K4 and K6, launched
   steps x iterations times over the loop and nothing else, the plain RNG on no CUDA tensor;
   the final model's validation loss below the random initial model's, every action finite
   and in bounds; the loop's checkpoint loads bit for bit (params, Adam state, stats, replay
   and its RNG), two policies with one seed act alike on both, and ``resume=True`` continues
   at the next refinement. Printed with the card's name and power limit: ``act()`` p50/p95,
   seconds per ``train()``, ms per epoch, seconds per refinement, and the idle share of one
   traced ``act()`` on the trained model.
7. PETS on ``"eager"`` (the JAX package refuses its kernels for Gaussian heads, sampled
   propagation and the penalty, and so does the port, but for ts_inf on ``"kernel"``). Part
   A, the planning step at the configuration of ``benchmarks/ckpt_tsinf_p20_lvb`` (S=18, U=6, 3x256 tanh, E=5, learned
   bounds, 20 particles; seeded weights, made-up stats and bounds) with the committed run's
   CEM (population 510, 50 elites, 5 iterations, H=15, two agents: 20 400 rows a step), with
   the cheetah reward: ``act()`` with ``ts_inf``, ``mm``, ``mean`` (the configuration of
   ``ckpt_gradient_bc_300``), ``mean`` with ``plan_uncertainty_penalty=1.0`` and ``ts1``.
   Gates: ``"fused"`` raises ``ValueError`` on each, ``"kernel"`` on each but ``ts_inf``,
   which it takes; the actions are finite and in bounds; no kernel launches; one traced
   ``act()`` waits for the card at most twice (ts1 and ts_inf are traced again with the member
   permutation made from numpy at every step, as before it was cached); the PETS cell's
   controller (phase 3's ts_inf net, 500 candidates x 20 particles, H=30) on ``"auto"``, which
   picks ``"kernel"``: 5 K2 launches an ``act()`` and no other kernel, at most two waits in
   a traced ``act()``; one ts_inf rollout of the 20 400 rows on the card against the CPU
   with the same weights and noise, 1e-4 of max(1, max|cpu|). Part B, the loop of phase 6 on
   the pendulum with that ensemble (ts_inf, 20 particles, learned bounds) and Part A's CEM:
   no kernel launches, the final validation NLL below the random model's, the calibration
   ratio finite and written after every ``train()``, the bounds moved, the checkpoint bit for
   bit (bounds and their Adam state too), resume, and a trained ``act()`` waiting at most
   twice. Phase 5 also traces fused CEM with ``exploration_noise=True``, with the noise's
   constants copied from numpy (as before) and from the device (at most two waits).
8. The rest of the solver registry and the POPLIN half. Part A, on ``"eager"`` at the
   configuration of ``benchmarks/cheetah_gradient_bc_300ep_run.jsonl`` (S=18, U=6, 5 x 3x256
   tanh Gaussian heads, mean, H=15, two agents, seeded weights): ``act()`` of Gradient (32
   restarts, 20 Adam steps) without and with a (64, 64) proposer and of CEM-GD (population 510,
   5 iterations); gates: ``"kernel"`` and ``"fused"`` refuse both, no kernel launches, at most
   two waits per traced ``act()``, remat's gradients within 1e-6 of plain (the peak memory of
   both printed), one ``adam_polish`` held against the CPU at every plan it visits (gradient
   and Adam update). Part B, at the flagship on ``"kernel"``: PSO and SPSA launch K2 once per
   iteration on 1000 and 2000 rows (at most two waits), K2 against its plain version on an SPSA
   2P batch; fused CEM seeded by a proposer launches K4 and K6 as without it (the unroll's host
   time printed); eager CEM time-major beside the standard layout. Part C, the speculative
   pipeline on fused CEM at the flagship width on the pendulum: ``spec_tol=None`` and a miss at
   every step give the synchronous per-step-seeded run's bits, K4/K6 once per iteration of each
   solve, at most two waits a pipelined step; the wall time per step with overlap off and on,
   on the native env and on one padded to 40 ms, and the hit rates. Part D, phase 6's loop on
   ``"fused"`` with ``behavior_cloning=True, overlap=True``: each cloning lowers the proposer's
   error, the checkpoint and ``resume=True`` keep handler and proposer bit for bit.

9. The single-card entry points. Part A, ``rollout_backend="auto"``: ``act()`` on ``"eager"``
   and ``"kernel"`` at H=50 over populations 100-10 000 and hidden widths (64, 64) and
   (500, 500, 500) (S=17, U=6, E=5), the grid behind ``ops/backend_select.py``'s constants; the
   peak memory per candidate row of ``"kernel"`` at 1000 and 3000 rows and of ``"eager"`` at
   20 000 and 60 000 rows (what ``auto`` runs above ``KERNEL_MAX_ROWS``), the capacity
   threshold the larger gives at half the card's memory, and one ``act()`` of the largest
   population ``auto`` sends to eager; ``auto`` at the flagship resolves to
   ``"kernel"`` with its bits (K2 five times an ``act()``), and with ``FUSED_MIN_BYTES``
   lowered to ``"fused"`` with its bits (K4 and K6 five times each). Part B,
   ``evaluate_solver_on_model`` for 20 steps: fused CEM over the flagship model as the env (K4
   and K6 five times a step) and eager CEM over the analytic pendulum, each with at most one
   ``cudaStreamSynchronize`` (its readback) under ``utils/profiling.py::trace``, against a host
   loop of ``act()``. Part C, an eager CEM ``MPCPolicy`` at the flagship exported after one
   ``act()`` and served by ``ServingPolicy`` on the card: three ``act()``s (explore false, true,
   false) and a reset bit for bit, swapped params as a policy given them, ``export_dynamics``
   at two batch sizes; export and load seconds, both ``act()``s' ms; one traced served
   ``act()`` waits at most twice (so does phase 11's compiled one). Part D, the command line
   as subprocesses: ``solvers``, ``solve`` (pendulum, cart-pole), ``export`` of phase 6's
   trained checkpoint and ``inspect``, ``serve`` (5 requests, a reset, a malformed line),
   ``calibrate`` on phase 7's probabilistic handler; ``learn`` needs gymnasium and runs only
   where it is installed. Part D runs while Part C exports and serves.
10. The parallel layer (``parallel/``, ``ops/fused_sharded.py``) at the flagship: fused CEM,
   iCEM with colored noise and ``population_decay``, PI2, MPPI, RandomSearch, sep-CMA-ES and
   eager CEM with ``mesh=``. Part A, a 1-rank NCCL world on the card: each drive's ``act()``s
   bit for bit with the unsharded policy's, its kernel launches (K4 and K6 once per
   iteration, ``draw_rows`` once per RandomSearch ``act()``), at most 2 waits in a traced
   sharded fused CEM ``act()``, and a data-parallel ``train()`` on phase 6's replay bit for bit
   with the unsharded one; the ``act()`` medians of both. Part B, two ranks sharing the card
   over gloo (spawned; NCCL refuses two ranks on one card): every drive, both ranks' ``act()``s
   bit for bit with each other and their launches; each rank's K4 rewards and K6 moments at
   its own seed against their plain versions (phase 3's tolerances), and the 2-rank card
   result (gathered rewards, reduced moments) against the same ranks on CPU tensors (the plain
   versions), 1e-4 of max(1, max|cpu|); medians and each rank's waits, printed. Part C,
   BASELINE config #5's scale: one warm sep-CMA-ES ``act()`` at population 100 000 (5 000
   elites) at one rank (NCCL) and at two (gloo), its seconds and peak memory, the actions
   finite and in bounds. Part B also measures each rank's peak memory in a sharded eager CEM
   ``act()`` per byte of the whole candidate tensor, which every rank holds (gated: no more
   than phase 9's unsharded eager figure, which sets ``FUSED_MIN_BYTES``), and times phase 7's
   ``ts_inf`` drive sharded over both ranks beside it unsharded on rank 0 alone. Part D, the
   sharded artifact: each rank of the gloo world exports an
   eager CEM policy (H=10, population 200) and its ``ServingPolicy`` continues bit for bit
   (greedy, noisy, after a reset); a process outside a 2-rank world is refused it.
11. The compiled serving cache and the tutorials. Part A, an eager CEM ``MPCPolicy`` at the
   flagship width cut to H=10, population 200, 2 iterations (phase 10 Part D's cut), exported
   after one ``act()``: ``precompile`` and ``save_compiled`` (AOTInductor, with a C++ compiler
   that links OpenMP, ``$CXX`` or the first found), then ``load(compiled_cache=)`` with the
   compile refused. Gates: the cache is used; three ``act()``s (explore false, true, false), a
   reset and one more give the saving instance's bits and agree with an uncompiled
   ServingPolicy within 1e-4; swapped params likewise; a cache of another device kind warns
   and is not used. Printed: compile, save and load seconds, the cache's bytes, ``act()`` ms
   of the compiled and uncompiled ServingPolicy and of ``MPCPolicy``, and one traced compiled
   ``act()``. ``python3 chip_smoke.py --compiled-flagship`` runs Part A alone at the flagship
   (H=50, 5 iterations). Part B, four tutorials of ``tutorials_torch/`` as subprocesses
   without ``--cpu`` (low_level_api, true_model_mpc/tutorial_one, deploy, beyond_hbm), each
   exiting 0 with its result line; beyond_hbm must launch K3, K4 and K6. Part B runs while
   Part A exports and compiles, and ends before Part A's timings.
12. The JAX package's checkpoints on the card, read by ``learning/orbax_read.py`` and written
   by ``learning/orbax_write.py`` with no JAX, Orbax, tensorstore or zstandard. Part A: the
   committed Orbax trees (the three ``benchmarks/ckpt_*/handler/checkpoint`` and
   ``ckpt_gradient_bc_300/proposer``) and the
   JAX-written loop ``tests/torch_fixtures/jax_pendulum_loop`` (handler and proposer), each
   leaf's dtype, shape and SHA-256 equal to ``tests/torch_fixtures/jax_checkpoint_digests.json``
   (Orbax's own restore on the CPU); the read seconds per tree. Part B: the three committed
   checkpoints through ``DynamicsHandler.load(..., device)``, one-step predictions card
   against CPU within 1e-4 of max(1, max|cpu|); phase 7's drives (ts_inf with 20 particles
   on both ts_inf checkpoints, mm, mean) and phase 8 A's Gradient+BC with the committed
   proposer, on the trained weights and stats: actions finite and in bounds, no kernel
   launched, at most 2 waits in a traced ``act()``, medians beside phases 7 and 8 A's seeded
   ones; ``calibrate`` on ``ckpt_tsinf_p20_lvb`` exits 0. Part C: the JAX-written loop,
   whose handler loads to its digests, resumed by the port for one refinement of 20 steps
   (phase 6's CEM, the fixture's (64, 64) model, its proposer) on ``"fused"`` and on
   ``"kernel"``: K4 and K6, or K2, 20 x 5 times and nothing else; the checkpoint it writes is
   the JAX package's format (below) and loads back bit for bit. Part D: each tree of Part A
   loaded onto the card (handlers by ``DynamicsHandler.load``, proposers by
   ``proposer_from_numpy``) and saved again by the port (``learning/orbax_write.py``):
   ``restore_pytree`` of what it wrote gives the committed digests (the replay and its RNG
   included); the save seconds per tree are printed beside Part A's read seconds. Part E,
   the JAX package's surface on the card, with the flagship ensemble: a ``Bounds`` whose old
   box's tensors and constants were made on the card is ``replace``d by a box of half the
   width, off centre; fused CEM (K4 and K6 five times), fused RandomSearch (K4 and the row draw
   K3 once each) and CEM on the rollout kernel (K2 five times) each solve on it with a fresh
   ``Bounds``' bits, every action and plan inside the new box, the launches exact, and a traced
   fused CEM ``act()`` on it waits exactly twice; ``export_dynamics(handler on the card,
   platforms=("cpu",))`` predicts on the CPU within 1e-4 of max(1, max|card|) of the handler;
   phase 8 A's Gradient solver with ``adam_polish`` given the float rate and a
   ``torch.optim.Adam`` callable at the same rate, on the same plans (those of the first
   polish of an ``act()``): the callable's plans finite, in bounds and within 0.01 of the float
   path's, relative to how far the float path moved them; both polish calls and both paths'
   ``act()`` timed here, the callable's ``act()`` at most 2 waits when profiled;
   ``rollout_backend="pallas"`` launches K2 as ``"kernel"`` and ``"xla"`` nothing, as
   ``"eager"``, each with the bits of the port's name.

The loops of phases 6, 7, 8 D and 12 C checkpoint in the JAX package's format: each written
``handler/checkpoint`` (and ``proposer/``) reads back to the leaves of
``models/convert.py::handler_to_numpy`` (``proposer_to_numpy``) of the live objects on the card,
bit for bit, and the directory holds no ``checkpoint.pt``, ``proposer.pt`` or OCDBT file (in
12 C, none of the JAX-written trees it resumed).

Before the kernels line, ``{"phase_seconds": {...}}`` gives the wall seconds of each phase
and part (``"9C"`` and ``"9D"`` overlap, as do ``"11A"`` and ``"11B"``; ``"10B"`` holds Parts
B-D at two ranks) and of the whole run (``"total"``). The line before the last two is
``{"kernels": [...]}`` (each kernel's launches on phase 5's main path, and ``launches_by_path``
on every path that runs it; ``rollout_states`` also gives its ``ts_inf`` case of phase 3;
``block_gemm``, B1, its host launches in phase 5's graphed RSSM ``act()``, its device launches
there, and its phase 3 timings at both block shapes, with ``torch.baddbmm`` as
``library_ms``);
then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from typing import Any, NamedTuple

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
# The float32 ceiling of split-operand 3xTF32: a third of the TF32 tensor cores' 495 TFLOP/s.
TF32X3_PEAK = 165e12
# The RSSM core's block layers at size200m: (groups, in, out), and the rows they run at.
BLOCK_SHAPES = ((8, 4096, 1024), (8, 1024, 3072))
BLOCK_ROWS = (1, 104, 1000)
# The RSSM cell's solve (port_bench/traffic/planet_closed_loop.json): PlaNet's CEM at H=12.
RSSM_SOLVE = dict(planning_horizon=12, population=1000, num_elite=100, max_iterations=10,
                  alpha=0.0, warm_start=False)
# The V-JEPA 2-AC cell's solve (port_bench/traffic/goal_cem_closed_loop.json).
VJEPA2_SOLVE = dict(planning_horizon=2, population=128, num_elite=10, max_iterations=3,
                    alpha=0.0, warm_start=False)
H100_BYTES_PER_S = 3.35e12
# Operations of one clipped normal draw of the counter RNG (K3), counted as float32 operations
# at the SIMT rate, a transcendental as one: the counter (2), two keyed uniforms (14 each:
# fmix32 is 8), Box-Muller (6) and the clip (2).
RNG_OPS = 38
FUSED_TILE = 128  # ts1's logical tile in phase 3: 8 tiles of 1000 rows for 5 members
EXTRA_SLOTS = 6  # the iCEM drive's injected candidates: keep_elites 5 + the mean
COLORED_BETA = 2.0


# Wall seconds of each phase and part (Parts 9 C and D, and 11 A and B, overlap), printed
# before the kernels line.
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def phase_timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


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


def block_gemm_cases(device) -> dict:
    """The block layer's kernel against float64 and ``torch.baddbmm`` at the RSSM's shapes
    (phase 3); returns and prints its timing line."""
    import torch

    from blackbox_mpc_torch.models import rssm
    from blackbox_mpc_torch.ops import block_gemm as bg

    gen = torch.Generator(device=device).manual_seed(25)
    timings = []
    for groups, fan_in, fan_out in BLOCK_SHAPES:
        w = torch.randn((groups, fan_in, fan_out), generator=gen, device=device) / fan_in ** 0.5
        b = 0.1 * torch.randn((groups, fan_out), generator=gen, device=device)
        layer = {"w": w, "b": b}
        for rows in BLOCK_ROWS:
            x = torch.nn.functional.silu(
                torch.randn((groups, rows, fan_in), generator=gen, device=device))
            before = rssm.block_linear.tensor_core_launches
            got = rssm.block_linear(x, layer)
            assert rssm.block_linear.tensor_core_launches == before + 1
            exact = torch.baddbmm(b.double()[:, None, :], x.double(), w.double())
            library = torch.baddbmm(b[:, None, :], x, w)
            err = float((got.double() - exact).abs().max())
            lib_err = float((library.double() - exact).abs().max())
            again = bg.block_gemm(x, w, b)
            static = torch.empty_like(got)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static.copy_(bg.block_gemm(x, w, b))
            graph.replay()
            torch.cuda.synchronize()
            case = {"shape": [groups, rows, fan_in, fan_out], "max_abs_err": err,
                    "baddbmm_max_abs_err": lib_err, "err_ratio": err / lib_err,
                    "repeat_bits": bool(torch.equal(got, again)),
                    "graph_bits": bool(torch.equal(got, static))}
            print(json.dumps({"block_gemm_case": case}), flush=True)
            if not (case["repeat_bits"] and case["graph_bits"] and err <= 4 * lib_err):
                raise AssertionError(f"block gemm kernel off: {case}")
            if rows == BLOCK_ROWS[-1]:
                flops = 2.0 * groups * rows * fan_in * fan_out
                timings.append({
                    "shape": case["shape"], "ms": graph_ms(lambda: bg.block_gemm(x, w, b)),
                    "bound_ms": flops / TF32X3_PEAK * 1e3,
                    "bound_ms_f32_simt": flops / H100_PEAK["float32"] * 1e3,
                    "library_ms": graph_ms(lambda: torch.baddbmm(b[:, None, :], x, w)),
                    "max_abs_err": err, "baddbmm_max_abs_err": lib_err})
                timings[-1]["tflops"] = flops / timings[-1]["ms"] / 1e9
    line = {"block_gemm": timings, "attributes": bg.gemm_attributes(), "packs": bg.packed.calls,
            "card": nvidia_smi()}
    print(json.dumps(line), flush=True)
    return line


def rssm_act_drive(device) -> dict:
    """DreamerV3 size200m planned by the RSSM cell's CEM on ``"auto"`` (eager, graphed), three
    ``act()``s: the first (its first evaluation eager, then the capture), a graphed one with
    the launch counters zeroed just before it, and a traced one. The block kernel's host
    launches must be 2 a core step outside the replays (the filter's, the lookahead's; the first
    evaluation's and the capture's 12 steps) and its device launches 2 a core step in all; the
    card's memory: the weights, their 3xTF32 pack and the peak over the ``act()``s alone."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models import rssm
    from blackbox_mpc_torch.ops import block_gemm as bg
    from blackbox_mpc_torch.utils import profiling

    config = rssm.RSSMConfig(obs_dim=17, action_dim=6)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = rssm.RSSMWorldModel(config, seed=25, device=device)
    weights = torch.cuda.memory_allocated() - base
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.action_dim), model.reward_fn, model,
                       rollout_backend="auto", seed=5, device=device, **RSSM_SOLVE)
    if policy.rollout_backend != "eager":
        raise AssertionError(f"RSSM: auto resolved to {policy.rollout_backend!r}, not 'eager'")
    obs = np.random.default_rng(25).normal(size=(3, config.obs_dim)).astype(np.float32)
    horizon, iters = RSSM_SOLVE["planning_horizon"], RSSM_SOLVE["max_iterations"]
    torch.cuda.reset_peak_memory_stats()
    counters = zero_launches()
    policy.act(obs[0], 0)
    first = read_launches(counters)
    pack = sum(t.nbytes for entry in bg._packs.values() for t in entry[2:])
    counters = zero_launches()
    t0 = time.perf_counter()
    policy.act(obs[1], 1)  # returns host arrays: synchronised
    act_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(counters)
    with tempfile.TemporaryDirectory() as log_dir, profiling.trace(log_dir) as prof:
        policy.act(obs[2], 2)
    device_launches = sum(1 for e in profiled_events(prof)
                          if e.device_type == DeviceType.CUDA and "block_gemm" in e.name)
    peak = torch.cuda.max_memory_allocated()
    graphs = policy.rollout_graphs
    run = {"rssm_act": "size200m, CEM 1000 x 10 iterations, H=12", "act_ms": act_ms,
           "launches": launches, "first_launches": first,
           "device_launches_per_act": device_launches, "weights_bytes": weights,
           "pack_bytes": pack, "acts_peak_bytes": peak,
           "captures": graphs.captures, "replays": graphs.replays, "card": nvidia_smi()}
    print(json.dumps(run), flush=True)
    want_first = {name: 2 + 4 * horizon + 2 if name == "block_gemm" else 0 for name in first}
    want = {name: 4 if name == "block_gemm" else 0 for name in launches}
    if (first, launches, device_launches) != (want_first, want, 2 * horizon * iters + 4):
        raise AssertionError(f"RSSM act(): launches off: {run}")
    if (graphs.captures, graphs.replays) != (1, 3 * iters - 1):
        raise AssertionError(f"RSSM act(): {graphs.captures} captures, {graphs.replays} replays")
    return run


def vjepa2_act_drive(device) -> dict:
    """V-JEPA 2-AC at the published widths planned by its cell's CEM on ``"auto"`` (eager,
    graphed) toward a seeded goal image, four ``act()``s: the first (its first evaluation
    eager, then the capture), two timed, and one traced. Gates: ``"auto"`` resolves to
    ``"eager"``; one capture and every later evaluation a replay; the cache 6.49 GB; the
    traced ``act()``'s host waits 2, and its device runs one attention kernel named as
    ``models.attention_share`` names them per attention call (40 encoder blocks, and 24
    predictor blocks in each of the 3 x 2 imagined frames and the lookahead's)."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models import vjepa2_ac as vj
    from blackbox_mpc_torch.utils import profiling

    spec = importlib.util.spec_from_file_location(
        "attention_share", in_repo("port_bench/metrics/models.attention_share.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    config = vj.VJEPA2ACConfig()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = vj.VJEPA2ACWorldModel(config, seed=26, device=device)
    weights = torch.cuda.memory_allocated() - base
    policy = MPCPolicy(BoxSpace.of(-0.075, 0.075, dim=config.action_dim), model.reward_fn,
                       model, rollout_backend="auto", seed=5, device=device, **VJEPA2_SOLVE)
    if policy.rollout_backend != "eager":
        raise AssertionError(f"V-JEPA 2-AC: auto resolved to {policy.rollout_backend!r}")
    rng = np.random.default_rng(26)
    obs = rng.uniform(0.0, 1.0, (5, config.obs_dim)).astype(np.float32)
    obs[:, -config.state_dim:] = rng.normal(0.0, 0.1, (5, config.state_dim))
    model.set_goal(obs[4, :-config.state_dim])
    torch.cuda.reset_peak_memory_stats()
    policy.act(obs[0], 0)
    act_ms = []
    for t in (1, 2):
        t0 = time.perf_counter()
        policy.act(obs[t], t)  # returns host arrays: synchronised
        act_ms.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as log_dir, profiling.trace(log_dir) as prof:
        policy.act(obs[3], 3)
    events = profiled_events(prof)
    attention = sum(1 for e in events if e.device_type == DeviceType.CUDA
                    and any(k in e.name for k in reader.ATTENTION_KERNELS))
    waits = sum(1 for e in events if e.name == "cudaStreamSynchronize")
    iters, horizon = VJEPA2_SOLVE["max_iterations"], VJEPA2_SOLVE["planning_horizon"]
    want_attention = config.enc_depth + config.pred_depth * (iters * horizon + 1)
    graphs = policy.rollout_graphs
    run = {"vjepa2_act": "ViT-g encoder, 300M predictor, CEM 128 x 3 iterations, H=2",
           "act_ms": act_ms, "kv_cache_bytes": model.kv_cache_bytes, "weights_bytes": weights,
           "acts_peak_bytes": torch.cuda.max_memory_allocated(),
           "attention_kernels_per_act": attention, "waits": waits,
           "captures": graphs.captures, "replays": graphs.replays, "card": nvidia_smi()}
    print(json.dumps(run), flush=True)
    if model.kv_cache_bytes != 24 * 2 * 128 * 258 * 1024 * 4:
        raise AssertionError(f"V-JEPA 2-AC: the cache holds {model.kv_cache_bytes} bytes")
    if (graphs.captures, graphs.replays) != (1, 4 * iters - 1):
        raise AssertionError(f"V-JEPA 2-AC: {graphs.captures} captures, {graphs.replays} "
                             "replays")
    if (attention, waits) != (want_attention, 2):
        raise AssertionError(f"V-JEPA 2-AC traced act(): {attention} attention kernels "
                             f"(want {want_attention}), {waits} waits (want 2)")
    return run


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

    sizes = [config.dim_s + config.dim_u, *config.hidden, config.mlp.out_dim]
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
    """K2: actions, s0 and ts_inf's noise in, weights in, states out; the MLP's FLOPs."""
    flops, weight_bytes = mlp_work(config, rows, horizon, members)
    sampled = config.propagation == "ts_inf"
    bytes_moved = (4 * horizon * rows * config.dim_u + 4 * rows * config.dim_s + weight_bytes
                   + 4 * horizon * rows * config.dim_s * (2 if sampled else 1))
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


def kernel_vs_plain(device, propagation: str, dtype: str, rows: int = ROWS, inputs=None,
                    label: str = "") -> dict:
    """K2 against its plain version on ``inputs`` (``actions [H, rows, U]``, ``s0 [rows, S]``
    on the card), or on uniform actions and normal states made from a seed. ``"ts_inf"``:
    PETS' net and launch (``ops/measure.py::pets_launch``: 10 000 particle rows in member-major
    blocks, H=30, the noise an input)."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    horizon, member, noise = HORIZON, None, None
    if propagation == "ts_inf":
        from blackbox_mpc_torch.ops.measure import PETS_HORIZON, pets_launch

        config, _, (_, ops, acts, s0, member, noise) = pets_launch(rk, device)
        horizon, rows, members = PETS_HORIZON, s0.shape[0], 1
    else:
        config = LearnedDynamicsConfig(**FLAGSHIP, propagation=propagation,
                                       compute_dtype=getattr(torch, dtype))
        ops = rk.make_operands(flagship_params(config, device), config)
        members = config.ensemble_size
        if inputs is None:
            g = np.random.default_rng(2)
            acts = torch.as_tensor(g.uniform(-1, 1, (HORIZON, rows, config.dim_u)),
                                   dtype=torch.float32, device=device)
            s0 = torch.as_tensor(g.normal(0, 1, (rows, config.dim_s)), dtype=torch.float32,
                                 device=device)
        else:
            acts, s0 = inputs
            rows = s0.shape[0]
    tile = rk.tile_rows(propagation in ("ts1", "ts_inf"), propagation == "ts_inf")
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
        return rk.rollout_states(config, ops, acts_pad, s0_pad, member, noise)

    def plain():
        return rk.rollout_states_plain(config, ops, acts, s0, member, noise)

    states, ref_states = kernel()[:, :rows], plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(states).all()):
        raise AssertionError(f"{propagation}/{dtype}: kernel states not finite")
    got, ref = rewards_from_states(s0, acts, states), rewards_from_states(s0, acts, ref_states)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    state_err = float((states - ref_states).abs().max())
    state_scale = max(1.0, float(ref_states.abs().max()))
    bound_ms, bound_by = bound(config, rows, horizon, members)
    res = {
        "case": f"{propagation}/{dtype}" + ("" if rows == ROWS else f" rows={rows}") + label,
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
    from blackbox_mpc_torch.ops import block_gemm as bg
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    return {"rollout_states": rk.rollout_states, "fused_rollout": fc.fused_rollout,
            "fused_rollout_streamed": fc.fused_rollout_streamed,
            "elite_moments": fc.elite_moments, "draw_rows": fc.draw_rows,
            "block_gemm": bg.block_gemm}


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
# The drives of which one more act() is traced, and the most cudaStreamSynchronize calls one
# act() may make: the observation's copy in and the action's copy out.
TRACED = ("fused", "fused iCEM", "fused CMA-ES")
MAX_SYNCS = 2


def host_copy_exploration_noise(generator, action, bounds, scale: float = 0.05):
    """The exploration noise as ``solvers/base.py`` drew it before its constants lived on the
    device: the midpoint and the std copied from numpy at every noisy ``act()``. Traced beside
    the repaired one to show the waits it made."""
    import torch

    from blackbox_mpc_torch.core.types import truncated_normal

    mid = torch.as_tensor(bounds.midpoint, dtype=action.dtype, device=action.device)
    std = torch.as_tensor((bounds.default_variance * scale) ** 0.5, dtype=action.dtype,
                          device=action.device)
    return bounds.clip(action + truncated_normal(generator, mid, std, action.shape))


def gate_waits(trace: dict, label: str) -> None:
    if trace["stream_syncs"] > MAX_SYNCS:
        raise AssertionError(f"{label}: {trace['stream_syncs']} cudaStreamSynchronize calls in "
                             f"one act(), more than {MAX_SYNCS}")


def scalar_scatter_by_rank(values, index, population: int):
    """The elite mask written from a Python scalar through ``index_put_``, as the fused CEM
    once did: the scalar is copied from pageable host memory, so the host waits for K4 in
    every iteration. Traced beside ``_scatter_by_rank`` (a device source) to show the cost."""
    import torch

    agents = index.shape[0]
    out = torch.zeros((population, agents), dtype=torch.float32, device=index.device)
    out[index.T, torch.arange(agents, device=index.device)[None, :]] = (
        1.0 if values is None else values[:, None])
    return out


# A traced act() whose trace lacks a K4 or K6 launch is traced again, at most this many times
# in all: the tracer has lost the first 8-10 ms of an act() (PERF.md §6).
TRACE_TRIES = 3
TRACED_KERNELS = (("k4_kernels", "fused_rollout"), ("k6_kernels", "elite_moments"))


def gate_traced_launches(trace: dict, label: str, per_act: dict) -> None:
    """The traced ``act()`` recorded each of K4's and K6's launches (``per_act``: the kernels'
    launches per ``act()``), so its idle share reads a whole trace."""
    for key, kernel in TRACED_KERNELS:
        if trace[key] != per_act.get(kernel, 0):
            raise AssertionError(f"{label}: the trace recorded {trace[key]} {kernel} kernels, "
                                 f"the act() launches {per_act.get(kernel, 0)}")


class TraceLost(AssertionError):
    """The profiler recorded no device operation in a traced ``act()``."""


def trace_act(policy, obs, label: str, exploration_noise: bool = False, per_act=None,
              every_try: bool = False) -> dict:
    """``trace_once``, traced again where the profiler recorded no device operation of the
    ``act()`` (a 3-5 ms compiled ``act()`` can fall inside the 8-10 ms the tracer sometimes
    loses), at most TRACE_TRIES times; with ``per_act`` (K4's and K6's launches per
    ``act()``) also until the trace records each launch, and gated: no idle share is read from
    a trace that lost records. ``every_try``: trace TRACE_TRIES times whatever they record
    (ranks of one world, whose act()s must stay in step), keeping the first whole one,
    ungated. ``lost_record_traces`` counts the traces that lacked a launch or every
    operation."""
    whole, trace, lost = None, None, 0
    for _ in range(TRACE_TRIES):
        try:
            trace = trace_once(policy, obs, label, exploration_noise)
        except TraceLost as err:
            lost += 1
            print(json.dumps({"trace_lost_records": label, "error": str(err)}), flush=True)
            continue
        if per_act is None or all(trace[key] == per_act.get(kernel, 0)
                                  for key, kernel in TRACED_KERNELS):
            whole = whole or trace
            if not every_try:
                break
        else:
            lost += 1
            print(json.dumps({"trace_lost_records": label, "k4_kernels": trace["k4_kernels"],
                              "k6_kernels": trace["k6_kernels"]}), flush=True)
    if trace is None:
        raise AssertionError(f"{label}: the profiler saw no device activity in "
                             f"{TRACE_TRIES} traced act()s")
    trace = whole or trace
    trace["lost_record_traces"] = lost
    if per_act is not None and not every_try:  # a rank's caller gates after the world ends
        gate_traced_launches(trace, label, per_act)
    return trace


class ProfiledEvent(NamedTuple):
    name: str
    device_type: Any  # torch.autograd.DeviceType
    start_us: float  # from the trace's start
    end_us: float
    is_user_annotation: bool


def profiled_events(prof) -> list:
    """The events of a finished ``torch.profiler`` run, read from its Kineto results: those
    ``prof.events()`` gives (no memory records, no hidden events), with the fields the gates
    read, without building ``FunctionEvent``s, which took 4.8 s for the 80 000 events of one
    Gradient ``act()`` on the CPU, against 0.25 s for these."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    return [ProfiledEvent(e.name(), e.device_type(), (e.start_ns() - t0) / 1000,
                          (e.end_ns() - t0) / 1000, e.is_user_annotation())
            for e in results.events()
            if e.name() not in ("[memory]", "[OutOfMemory]") and not e.is_hidden_event()]


def trace_once(policy, obs, label: str, exploration_noise: bool = False) -> dict:
    """One ``act()`` under ``torch.profiler`` (after one more that the trace does not read):
    the ten device operations that take the most time, the launches of K4's, K6's and K3's
    kernels, the share of the ``act()`` window (the host's
    range around it, which ends in the copy of the action to the host) in which the device ran
    nothing, and the longest stretches of it, each with its start in the window and the device
    operation that ended it."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from blackbox_mpc_torch.utils import profiling

    with tempfile.TemporaryDirectory() as log_dir, profiling.trace(log_dir) as prof:
        # The trace reads the second act(): the tracer may miss the first device operations
        # of its active step (in a 1-rank NCCL world a sharded act()'s first 10 ms, its first
        # K4 among them, despite the profiler's warm-up step), and the first act() takes that.
        policy.act(obs, exploration_noise=exploration_noise)
        with record_function("act"):
            policy.act(obs, exploration_noise=exploration_noise)
    events = profiled_events(prof)
    window = next(e for e in events if e.name == "act" and e.device_type == DeviceType.CPU)
    lo_us, hi_us = window.start_us, window.end_us
    # The host's waits for the device: each cudaStreamSynchronize (a blocking copy, a read of
    # a device value) holds the host until the stream drains.
    syncs, event_syncs = (sum(1 for e in events if e.name == name
                              and e.device_type == DeviceType.CPU
                              and lo_us <= e.start_us <= hi_us)
                          for name in ("cudaStreamSynchronize", "cudaEventSynchronize"))
    spans = sorted((e.start_us, e.end_us, e.name) for e in events
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and lo_us <= e.start_us <= hi_us)
    if not spans:
        raise TraceLost(f"{label}: the profiler saw no device activity in act()")
    busy, reached = 0.0, lo_us
    by_name: dict = {}
    gaps = []  # (idle us, its start from the window's, the device operation after it)
    for start, end, name in spans:
        lo, hi = min(max(start, reached), hi_us), min(end, hi_us)
        if lo > reached:
            gaps.append((lo - reached, reached - lo_us, name[:60]))
        if hi > lo:
            busy += hi - lo
        reached = max(reached, hi)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
    gaps.append((hi_us - reached, reached - lo_us, "(end of act)"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    res = {"trace": label, "act_window_us": hi_us - lo_us, "device_busy_us": busy,
           "device_idle_share": 1.0 - busy / (hi_us - lo_us),
           "idle_gaps_us": [{"us": us, "at_us": at, "before": name}
                            for us, at, name in sorted(gaps, reverse=True)[:6]],
           "device_ops": len(spans), "stream_syncs": syncs, "event_syncs": event_syncs,
           "k4_kernels": sum(n for name, (_, n) in by_name.items()
                             if "fused_rollout_kernel" in name),
           "k6_kernels": sum(n for name, (_, n) in by_name.items() if "moments_" in name),
           "draw_rows_kernels": sum(n for name, (_, n) in by_name.items()
                                    if "draw_rows_kernel" in name),
           "top_device_ops_us": [{"name": name[:90], "us": t, "count": n}
                                 for name, (t, n) in top]}
    print(json.dumps(res), flush=True)
    return res


def timed_acts(policy, obs, steps: int, label: str):
    """``steps`` closed-loop ``act()`` calls, each action finite and in [-1, 1] and each
    prediction finite. Returns the ms of each, every kernel's launches over them (the counts
    set to 0 just before), the plain RNG's calls on CUDA tensors and the last ``act()``."""
    import numpy as np

    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    times = []
    with plain_rng_on_cuda() as plain_calls:
        for t in range(steps):
            t0 = time.perf_counter()
            out = policy.act(obs, t)  # returns host arrays: synchronised
            times.append((time.perf_counter() - t0) * 1e3)
            action, obs, reward = out
            if not (np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)):
                raise AssertionError(f"{label}: action out of bounds or not finite: {action}")
            if not (np.all(np.isfinite(obs)) and np.all(np.isfinite(reward))):
                raise AssertionError(f"{label}: predicted next obs/reward not finite")
    launches = {name: wrapper.launches for name, wrapper in counters.items()}
    return times, launches, plain_calls, out


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
    times, launches, plain_calls, (action, obs, reward) = timed_acts(policy, obs, steps, label)
    expected = {name: steps * per_act.get(name, 0) for name in launches}
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
        if label == "fused":
            from blackbox_mpc_torch.ops import fused_cem as fc

            repaired = fc._scatter_by_rank
            in_turns = {"scalar_scatter": [], "device_source_scatter": []}
            try:
                fc._scatter_by_rank = scalar_scatter_by_rank
                before = trace_act(policy, obs, "fused, the elite mask from a Python scalar",
                                   per_act=per_act)
                # act() with either scatter, in turns: scalar, device, device, scalar.
                for name in ("scalar_scatter", "device_source_scatter") * 2:
                    fc._scatter_by_rank = (scalar_scatter_by_rank
                                           if name == "scalar_scatter" else repaired)
                    for _ in range(steps):
                        t0 = time.perf_counter()
                        policy.act(obs)
                        in_turns[name].append((time.perf_counter() - t0) * 1e3)
            finally:
                fc._scatter_by_rank = repaired
        res["trace"] = trace_act(policy, obs, label, per_act=per_act)
        if label == "fused":
            # act(exploration_noise=True), with the noise's constants copied from the host at
            # every act() (before) and from the device (after).
            from blackbox_mpc_torch.policies import mpc_policy

            repaired_noise = mpc_policy._exploration_noise
            try:
                mpc_policy._exploration_noise = host_copy_exploration_noise
                noise_before = trace_act(policy, obs, "fused, exploration noise copied from "
                                         "the host", exploration_noise=True, per_act=per_act)
            finally:
                mpc_policy._exploration_noise = repaired_noise
            res["noise_trace"] = trace_act(policy, obs, "fused, exploration noise",
                                           exploration_noise=True, per_act=per_act)
            gate_waits(res["noise_trace"], "fused, exploration noise")
            print(json.dumps({"exploration_noise_stream_syncs": {
                "host_copy": noise_before["stream_syncs"],
                "device_constants": res["noise_trace"]["stream_syncs"]},
                "card": nvidia_smi()}), flush=True)
            print(json.dumps({"device_idle_share_fused_cem_act": {
                "scalar_scatter": before["device_idle_share"],
                "device_source_scatter": res["trace"]["device_idle_share"]},
                "stream_syncs": {"scalar_scatter": before["stream_syncs"],
                                 "device_source_scatter": res["trace"]["stream_syncs"]},
                "act_ms_in_turns": {k: {"median": float(np.median(v)), "all": v}
                                    for k, v in in_turns.items()},
                "card": nvidia_smi()}), flush=True)
        if label == "fused" and res["trace"]["stream_syncs"] != MAX_SYNCS:
            raise AssertionError(f"{label}: {res['trace']['stream_syncs']} cudaStreamSynchronize "
                                 f"calls in one act(), expected {MAX_SYNCS} (observation in, "
                                 "action out)")
        gate_waits(res["trace"], label)
        if res["trace"]["draw_rows_kernels"] != per_act.get("draw_rows", 0):
            raise AssertionError(f"{label}: {res['trace']['draw_rows_kernels']} draw_rows "
                                 f"kernels in one act(), expected {per_act.get('draw_rows', 0)}")
    return res


# Phase 6: the MBRL loop at the flagship network width on the native pendulum (S=3, U=1), two
# agents, CEM at H=50, population 1000, 50 elites, 5 iterations.
MBRL = dict(num_envs=2, episode_steps=50, initial_rollouts=1, refinements=2, epochs=5,
            batch_size=128)
MBRL_RESUME_STEPS = 5  # the resumed refinement collects this many steps


@contextlib.contextmanager
def uncounted(plain_calls: dict):
    """Launches, operand packs and plain RNG calls made inside are not counted: gate 1's
    comparisons run their own evaluators and plain versions beside the policy's."""
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    counters = launch_counters()
    saved = {name: wrapper.launches for name, wrapper in counters.items()}
    packs, plain = rk.make_operands.calls, dict(plain_calls)
    try:
        yield
    finally:
        for name, wrapper in counters.items():
            wrapper.launches = saved[name]
        rk.make_operands.calls = packs
        plain_calls.update(plain)


def trained_kernels_vs_plain(device, handler, obs) -> dict:
    """Gate 1 on the handler's trained weights and fitted stats: K2 (through the kernel
    evaluator) against the eager evaluator on the same candidates, and K4 against its plain
    version on the same inputs, at two agents x population ROWS; rewards, states and actions
    within TOLERANCE["float32"] relative to max(1, max |plain|)."""
    from functools import partial

    import torch

    from blackbox_mpc_torch.models.analytic import pendulum_reward
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk
    from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

    config, dp = handler.config, handler.dynamics_params
    agents = obs.shape[0]
    rows = ROWS * agents
    g = torch.Generator(device=device).manual_seed(11)
    s0 = torch.as_tensor(obs, dtype=torch.float32, device=device)
    acts = torch.rand((ROWS, agents, HORIZON, config.dim_u), generator=g, device=device) * 4 - 2
    got = rk.make_rollout_kernel_evaluator(config, pendulum_reward, device=device)(dp, s0, acts)
    ref = make_trajectory_evaluator(partial(handler.dynamics_fn, dp), pendulum_reward,
                                    device=device)(s0, acts)
    errs = {"k2_rewards": (got, ref)}
    ops = rk.make_operands(dp, config)
    mean = torch.zeros((agents, HORIZON * config.dim_u), device=device)
    std = torch.full_like(mean, 1.0)
    seed = torch.tensor([24681357], dtype=torch.int32, device=device)
    rows_pad = -(-rows // rk.TILE_MEAN) * rk.TILE_MEAN
    states, actions = (o[:, :rows] for o in fc.fused_rollout(config, ops, s0, mean, std, seed,
                                                              rows_pad))
    ref_states, ref_actions = fc.fused_rollout_plain(config, ops, s0, mean, std, seed, rows)
    errs.update(k4_states=(states, ref_states), k4_actions=(actions, ref_actions))
    out = {}
    for what, (a, b) in errs.items():
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"trained {what}: not finite")
        err, scale = float((a - b).abs().max()), max(1.0, float(b.abs().max()))
        out[what] = err / scale
        if err > TOLERANCE["float32"] * scale:
            raise AssertionError(f"trained {what}: kernel vs plain {err} > "
                                 f"{TOLERANCE['float32']} * {scale}")
    return out


def same_bits(a, b) -> bool:
    """Tensors or arrays of one dtype and shape whose bytes are equal."""
    import numpy as np
    import torch

    a, b = ((x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def checkpoint_matches(handler, loaded) -> None:
    """Gate 5: ``loaded`` holds ``handler``'s params (trainable and planning), Adam state, step,
    stats, replay and RNG state, bit for bit."""
    from blackbox_mpc_torch.learning.trainer import flat_params
    from blackbox_mpc_torch.models.normalizer import STATS_FIELDS

    a, b = handler.train_state, loaded.train_state
    # flat_params: w, b of each layer, then the learned logvar bounds where the config has them.
    pairs = [(f"params {i}", x.detach(), y.detach())
             for i, (x, y) in enumerate(zip(flat_params(a.params), flat_params(b.params)))]
    pairs += [(f"planning {i}", x, y) for i, (x, y) in enumerate(zip(
        flat_params(handler.dynamics_params.params), flat_params(loaded.dynamics_params.params)))]
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    pairs += [(f"adam {i} {k}", sa[i][k], sb[i][k]) for i in sa for k in sa[i]]
    pairs += [(f"stats {f}", getattr(handler.dynamics_params.stats, f),
               getattr(loaded.dynamics_params.stats, f)) for f in STATS_FIELDS]
    ra, rb = handler.replay.state_dict(), loaded.replay.state_dict()
    pairs += [(f"replay {k}", ra[k], rb[k]) for k in ra]
    bad = [what for what, x, y in pairs if not same_bits(x, y)]
    if bad or a.step != b.step or sorted(sa) != sorted(sb):
        raise AssertionError(f"checkpoint round trip differs: {bad}, step {a.step} vs {b.step}")


# What a directory the port checkpointed may not hold: an OCDBT tree's files, or the payloads
# that earlier versions of the port wrote instead of the JAX package's trees.
NOT_WRITTEN = ("manifest.ocdbt", "d", "ocdbt.process_0", "_sharding", "array_metadatas",
               "checkpoint.pt", "proposer.pt")


def stray_files(directory: str) -> list:
    """The paths under ``directory`` named in ``NOT_WRITTEN``."""
    import os

    return sorted(os.path.join(root, name) for root, dirs, files in os.walk(directory)
                  for name in dirs + files if name in NOT_WRITTEN)


def written_in_jax_format(directory: str, handler, proposer, label: str) -> None:
    """The loop checkpoint in ``directory`` is the JAX package's: ``handler/checkpoint`` (and
    ``proposer/`` where ``proposer`` is given) read back by ``restore_pytree`` to the leaves of
    ``handler_to_numpy``/``proposer_to_numpy`` of the live objects, bit for bit, and no file
    of ``NOT_WRITTEN`` anywhere in it."""
    from blackbox_mpc_torch.learning.orbax_read import leaf_digests, restore_pytree
    from blackbox_mpc_torch.models.convert import handler_to_numpy, proposer_to_numpy

    gate_digests(leaf_digests(restore_pytree(f"{directory}/handler/checkpoint")),
                 leaf_digests(handler_to_numpy(handler)[1]), f"{label}: handler/checkpoint")
    if proposer is not None:
        gate_digests(leaf_digests(restore_pytree(f"{directory}/proposer")),
                     leaf_digests(proposer_to_numpy(proposer)), f"{label}: proposer/")
    stray = stray_files(directory)
    if stray:
        raise AssertionError(f"{label}: the checkpoint holds {stray}")


def mbrl_loop(device, backend: str) -> dict:
    """Phase 6 on one rollout backend: ``learn_dynamics_iteratively_w_mpc`` from a random
    bootstrap through MBRL["refinements"] refinements, each collecting one episode with
    ``MPCPolicy`` on ``backend`` planning on the trained weights; then the five gates."""
    import tempfile

    import numpy as np
    import torch

    from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MetricsWriter,
                                    MPCPolicy, learn_dynamics_iteratively_w_mpc)
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.models.analytic import pendulum_reward
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    smi = nvidia_smi()
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=FLAGSHIP["hidden"],
                                   ensemble_size=FLAGSHIP["ensemble_size"], propagation="mean")
    solver = dict(solver_name="CEM", planning_horizon=HORIZON, population=ROWS, num_elite=50,
                  max_iterations=ITERS, rollout_backend=backend, seed=0)
    env = NativePendulumVecEnv(num_envs=MBRL["num_envs"], seed=0,
                               max_episode_steps=MBRL["episode_steps"])
    handler = DynamicsHandler(config, seed=0, device=device)
    initial = [{k: v.clone() for k, v in layer.items()} for layer in handler.dynamics_params.params]
    writer = MetricsWriter()
    trains = []  # per train(): its seconds, epochs, ms per epoch, val loss
    marks = []  # (train() done, gate 1 done): a refinement runs from one gate 1 to the next train
    gate1 = []
    train = handler.train

    # The checkpoints live in a temporary directory that goes with the phase.
    with tempfile.TemporaryDirectory(prefix="mbrl_") as ckpt:
        with plain_rng_on_cuda() as plain_calls:
            def timed_train(*args, **kwargs):
                t0 = time.perf_counter()
                metrics = train(*args, **kwargs)
                torch.cuda.synchronize()
                done = time.perf_counter()
                trains.append({"train_s": done - t0, "epochs": metrics["epochs_ran"],
                               "ms_per_epoch": (done - t0) * 1e3 / metrics["epochs_ran"],
                               "val_loss": metrics["val_loss"]})
                with uncounted(plain_calls):
                    obs = handler.replay.arrays()[2][-MBRL["num_envs"]:]
                    gate1.append(trained_kernels_vs_plain(device, handler, obs))
                marks.append((done, time.perf_counter()))
                return metrics

            handler.train = timed_train
            counters = launch_counters()
            for wrapper in counters.values():
                wrapper.launches = 0
            rk.make_operands.calls = 0
            t0 = time.perf_counter()
            handler, policy = learn_dynamics_iteratively_w_mpc(
                env, pendulum_reward, number_of_initial_rollouts=MBRL["initial_rollouts"],
                number_of_rollouts_per_refinement=1, number_of_refinement_steps=MBRL["refinements"],
                rollout_horizon=MBRL["episode_steps"], handler=handler, epochs=MBRL["epochs"],
                batch_size=MBRL["batch_size"], metrics_writer=writer, checkpoint_dir=ckpt,
                device=device, **solver)
        loop_s = time.perf_counter() - t0
        launches = {name: wrapper.launches for name, wrapper in counters.items()}
        packs = rk.make_operands.calls
        label = f"MBRL {backend}"
        # Gate 2: the policy's evaluator packs once at its first act() and once after each train()
        # that precedes an act(): the refinements but the last.
        if packs != MBRL["refinements"]:
            raise AssertionError(f"{label}: {packs} operand packs, expected {MBRL['refinements']}")
        # Gate 3: every solve launched its kernels once per iteration, and nothing else ran.
        acts = MBRL["refinements"] * MBRL["episode_steps"]
        expected = {name: 0 for name in counters}
        expected.update({name: acts * n for name, n in BACKEND_KERNELS[backend].items()})
        if launches != expected:
            raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
        if any(plain_calls.values()):
            raise AssertionError(f"{label}: the plain RNG ran on CUDA tensors: {plain_calls}")
        # Gate 4: the model learned, and every action taken was finite and in bounds.
        final_val = float(np.mean(handler.validation_losses(handler.dynamics_params.params)))
        initial_val = float(np.mean(handler.validation_losses(initial)))
        if not final_val < initial_val:
            raise AssertionError(f"{label}: validation loss {final_val} not below the random "
                                 f"model's {initial_val}")
        taken = handler.replay.arrays()[1]
        if not (np.isfinite(taken).all() and np.abs(taken).max() <= 2.0):
            raise AssertionError(f"{label}: an action was not finite or out of bounds")
        # Gate 5: the loop's last checkpoint is the JAX package's tree of the returned handler
        # and loads as it, bit for bit; two policies with one seed act alike on both; a resumed
        # loop continues at the next refinement and checkpoints in that format too.
        written_in_jax_format(ckpt, handler, None, label)
        loaded = DynamicsHandler.load(f"{ckpt}/handler", device=device)
        checkpoint_matches(handler, loaded)
        obs = env.reset()
        first = [MPCPolicy(env.action_space, pendulum_reward, h, num_agents=MBRL["num_envs"],
                           device=device, **solver).act(obs)[0] for h in (handler, loaded)]
        if not same_bits(*first):
            raise AssertionError(f"{label}: the loaded handler's first action differs: {first}")
        resumed, _ = learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, number_of_refinement_steps=MBRL["refinements"] + 1,
            rollout_horizon=MBRL_RESUME_STEPS, epochs=1, batch_size=MBRL["batch_size"],
            checkpoint_dir=ckpt, resume=True, device=device, **solver)
        with open(f"{ckpt}/loop_state.json") as f:
            completed = json.load(f)["completed_refinements"]
        grown = len(resumed.replay) - len(loaded.replay)
        if (completed, grown) != (MBRL["refinements"] + 1, MBRL_RESUME_STEPS * MBRL["num_envs"]):
            raise AssertionError(f"{label}: resume ran to {completed} refinements and added "
                                 f"{grown} transitions")
        written_in_jax_format(ckpt, resumed, None, f"{label}, resumed")
        trace = trace_act(policy, obs, f"{label}, trained", per_act=BACKEND_KERNELS[backend])
    history = writer.history
    res = {
        "mbrl": backend, "card": smi, "loop_s": loop_s, "acts": acts, "launches": launches,
        "operand_packs": packs, "trained_kernel_vs_plain_rel_err": gate1,
        "val_loss": {"initial_random_model": initial_val, "final": final_val},
        "act_ms_p50": [1e3 * v for _, v in history["perf/act_latency_p50_s"]],
        "act_ms_p95": [1e3 * v for _, v in history["perf/act_latency_p95_s"]],
        "trains": trains,
        "refinement_wall_s": [done - gated for (done, _), (_, gated) in zip(marks[1:], marks)],
        "checkpoint": "bit for bit", "resumed_at": MBRL["refinements"],
        "trained_act_device_idle_share": trace["device_idle_share"],
        "trained_act_stream_syncs": trace["stream_syncs"],
    }
    print(json.dumps(res), flush=True)
    res["handler"] = handler  # phase 9 exports it through the command line
    return res


# Phase 7: the PETS stack on "eager" at the configuration of benchmarks/ckpt_tsinf_p20_lvb
# (HalfCheetah, S=18, U=6, a 5-member 3x256 tanh Gaussian ensemble) with the committed run's
# planning settings (benchmarks/cheetah_tsinf_p20_run.jsonl line 1, cheetah_mbrl.py:117-118,
# 174-192): CEM, population 510, 50 elites, 5 iterations, H=15, two agents, 20 particles,
# so 20 400 rows a step. Seeded weights, made-up stats and bounds.
PETS_NET = dict(dim_s=18, dim_u=6, hidden=(256, 256, 256), ensemble_size=5, probabilistic=True)
PETS_SOLVER = dict(solver_name="CEM", planning_horizon=15, population=510, num_elite=50,
                   max_iterations=ITERS)
PETS_AGENTS, PETS_PARTICLES = 2, 20
# The configurations driven, by label: ts_inf and mm as ckpt_tsinf_p20_lvb, mean as
# ckpt_gradient_bc_300, mean with the uncertainty penalty, and ts1 for the wait gate.
PETS_DRIVES = {
    "ts_inf": dict(propagation="ts_inf", num_particles=PETS_PARTICLES, learn_logvar_bounds=True),
    "mm": dict(propagation="mm", num_particles=PETS_PARTICLES, learn_logvar_bounds=True),
    "mean": dict(propagation="mean"),
    "mean + penalty": dict(propagation="mean", plan_uncertainty_penalty=1.0),
    "ts1": dict(propagation="ts1"),
}
# Traced once more with the member permutation made from numpy at every step, as before it
# was cached on the device.
UNCACHED = ("ts1", "ts_inf")


def cheetah_reward(s, a, ns):
    # benchmarks/cheetah_mbrl.py:90-93: the root's forward velocity minus an action cost.
    return (ns[:, 0] - s[:, 0]) / 0.05 - 0.1 * (a * a).sum(-1)


def pets_params(config, device):
    """Seeded weights and made-up stats (``flagship_params``); made-up learned bounds."""
    import numpy as np
    import torch

    dp = flagship_params(config, device)
    if not isinstance(dp.params, dict):
        return dp
    g = np.random.default_rng(2)
    bounds = {name: torch.as_tensor(g.uniform(lo, hi, config.dim_s), dtype=torch.float32,
                                    device=device)
              for name, lo, hi in (("lv_min", -8.0, -5.0), ("lv_max", -2.0, 0.0))}
    return dp.replace(params={**dp.params, **bounds})


@contextlib.contextmanager
def eager_loop():
    """Every eager evaluation inside runs the eager loop, none a CUDA graph."""
    from blackbox_mpc_torch.rollout import evaluator

    graphable = evaluator._graphable
    evaluator._graphable = lambda inputs: False
    try:
        yield
    finally:
        evaluator._graphable = graphable


@contextlib.contextmanager
def uncached_member_permutation():
    """``ts1``/``ts_inf`` make their member permutation from numpy at every step, as before
    it was cached: two host-to-device copies a step, each a wait. The evaluations run the
    eager loop (a replayed graph makes no permutation)."""
    from blackbox_mpc_torch.models import dynamics

    cached = dynamics.member_permutation
    dynamics.member_permutation = cached.__wrapped__
    try:
        with eager_loop():
            yield
    finally:
        dynamics.member_permutation = cached


def pets_act(device, label: str, steps: int = STEPS) -> dict:
    """``steps`` closed-loop ``act()`` calls on ``"eager"`` after a warm-up; the kernel
    backends must refuse the configuration (``"kernel"`` takes ts_inf), no kernel may launch,
    every evaluation after the warm-up's first must replay its CUDA graph, and one traced
    ``act()`` may wait for the card at most MAX_SYNCS times."""
    import numpy as np

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    config = LearnedDynamicsConfig(**PETS_NET, **PETS_DRIVES[label])
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(pets_params(config, device))
    space = BoxSpace.of(-1.0, 1.0, dim=config.dim_u)

    def policy(backend):
        return MPCPolicy(space, cheetah_reward, handler, num_agents=PETS_AGENTS,
                         rollout_backend=backend, seed=0, device=device, **PETS_SOLVER)

    refusals = {}
    for backend in ("kernel", "fused"):
        if backend == "kernel" and config.propagation == "ts_inf":
            # the rollout kernel samples ts_inf: pets_kernel_act drives it at the PETS cell's
            # shape, where "auto" picks it (here it takes 20 400 rows, beyond KERNEL_MAX_ROWS)
            if policy(backend).rollout_backend != "kernel":
                raise AssertionError(f"PETS {label}: rollout_backend='kernel' not taken")
            continue
        try:
            policy(backend)
        except ValueError as err:
            refusals[backend] = str(err)
        else:
            raise AssertionError(f"PETS {label}: rollout_backend={backend!r} did not refuse")
    eager = policy("eager")
    obs = np.zeros((PETS_AGENTS, config.dim_s), np.float32)
    eager.act(obs)  # warm-up
    times, launches, plain_calls, (_, obs, _) = timed_acts(eager, obs, steps, f"PETS {label}")
    if any(launches.values()) or any(plain_calls.values()):
        raise AssertionError(f"PETS {label}: kernels launched {launches}, plain RNG on CUDA "
                             f"{plain_calls}; the PETS path launches none")
    graphs = eager.rollout_graphs
    counts = {"captures": graphs.captures, "replays": graphs.replays, "graphs": graphs.graphs,
              "graph_bytes": graphs.graph_bytes}
    if (graphs.captures, graphs.replays) != (1, (steps + 1) * ITERS - 1):
        raise AssertionError(f"PETS {label}: rollout graphs {counts}, expected one capture "
                             "and every later evaluation replayed")
    res = {"pets": label, "card": nvidia_smi(), "rows_per_step": (
        PETS_SOLVER["population"] * PETS_AGENTS
        * (PETS_PARTICLES if config.propagation in ("ts_inf", "mm") else 1)),
        "act_ms": times, "act_ms_median": float(np.median(times)), "launches": launches,
        "rollout_graphs": counts, "refusals": refusals}
    if label in UNCACHED:
        with uncached_member_permutation():
            res["stream_syncs_uncached_permutation"] = trace_act(
                eager, obs, f"PETS {label}, permutation from numpy")["stream_syncs"]
    trace = trace_act(eager, obs, f"PETS {label}")
    gate_waits(trace, f"PETS {label}")
    res.update(stream_syncs=trace["stream_syncs"], device_idle_share=trace["device_idle_share"],
               traced_act_window_us=trace["act_window_us"], device_ops=trace["device_ops"])
    print(json.dumps(res), flush=True)
    return res


def pets_kernel_act(device, steps: int = STEPS) -> dict:
    """The PETS cell's controller (``ops/measure.py``'s ``PETS`` net and ``pets_params``: 500
    candidates x 20 particles, H=30, CEM with 50 elites and ITERS iterations) on ``"auto"``,
    which must pick ``"kernel"``: ``steps`` closed-loop ``act()`` calls after a warm-up launch
    K2's ts_inf instantiation once per iteration and no other kernel (the counts set to 0 just
    before), and one traced ``act()`` waits for the card at most MAX_SYNCS times."""
    import numpy as np

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.ops.measure import PETS, PETS_HORIZON, PETS_POPULATION, pets_params

    label = "PETS ts_inf, auto"
    config = LearnedDynamicsConfig(**PETS)
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(pets_params(config, device))
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.dim_u), cheetah_reward, handler,
                       planning_horizon=PETS_HORIZON, population=PETS_POPULATION, num_elite=50,
                       max_iterations=ITERS, alpha=0.1, rollout_backend="auto", seed=0,
                       device=device)
    if policy.rollout_backend != "kernel":
        raise AssertionError(f"{label}: resolved to {policy.rollout_backend!r}, not 'kernel'")
    obs = np.zeros(config.dim_s, np.float32)
    policy.act(obs)  # warm-up
    times, launches, plain_calls, (_, obs, _) = timed_acts(policy, obs, steps, label)
    expected = {name: steps * BACKEND_KERNELS["kernel"].get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}; "
                             f"plain RNG on CUDA {plain_calls}")
    trace = trace_act(policy, obs, label)
    gate_waits(trace, label)
    res = {"pets": label, "card": nvidia_smi(),
           "rows_per_step": PETS_POPULATION * config.num_particles, "act_ms": times,
           "act_ms_median": float(np.median(times)), "launches": launches,
           "launches_per_act": launches["rollout_states"] / steps,
           "stream_syncs": trace["stream_syncs"], "device_idle_share": trace["device_idle_share"],
           "device_ops": trace["device_ops"]}
    print(json.dumps(res), flush=True)
    return res


def pets_rollout_card_vs_cpu(device) -> dict:
    """One ts_inf rollout of the act()'s 20 400 rows (particle-major layout of the
    evaluator) on the card and on the CPU, with the same weights and the same noise: the
    visited states and the returns within TOLERANCE["float32"] of max(1, max|cpu|)."""
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
    from blackbox_mpc_torch.rollout.evaluator import rollout_trajectories

    config = LearnedDynamicsConfig(**PETS_NET, **PETS_DRIVES["ts_inf"])
    dp = pets_params(config, device)
    fn = make_learned_dynamics(config)[1]
    rows = PETS_SOLVER["population"] * PETS_PARTICLES * PETS_AGENTS
    horizon = PETS_SOLVER["planning_horizon"]
    g = torch.Generator().manual_seed(13)
    s0 = 0.5 * torch.randn((rows, config.dim_s), generator=g)
    acts = 2.0 * torch.rand((rows, horizon, config.dim_u), generator=g) - 1.0
    noise = torch.randn((horizon, rows, config.dim_s), generator=g)
    out = {}
    for where, params in (("cpu", dp.to("cpu")), ("card", dp)):
        on = torch.device("cpu") if where == "cpu" else device
        t0 = time.perf_counter()
        out[where] = [x.cpu() for x in rollout_trajectories(
            lambda s, a, n, p=params: fn(p, s, a, n), cheetah_reward, s0.to(on), acts.to(on),
            noise=noise.to(on), return_states=True)]
        out[f"{where}_s"] = time.perf_counter() - t0
    res = {"pets_rollout_card_vs_cpu": "ts_inf", "rows": rows, "horizon": horizon,
           "cpu_s": out["cpu_s"], "card_s": out["card_s"]}
    for i, what in enumerate(("returns", "states")):
        ref, got = out["cpu"][i], out["card"][i]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"PETS rollout on the card: {what} not finite")
        err, scale = float((got - ref).abs().max()), max(1.0, float(ref.abs().max()))
        res[f"{what}_rel_err"] = err / scale
        if err > TOLERANCE["float32"] * scale:
            raise AssertionError(f"PETS rollout {what}: card vs CPU {err} > "
                                 f"{TOLERANCE['float32']} * {scale}")
    print(json.dumps(res), flush=True)
    return res


def pets_loop(device) -> dict:
    """Part B: ``learn_dynamics_iteratively_w_mpc`` on the native pendulum with a PETS
    ensemble (3x256, E=5, learned bounds, ts_inf, 20 particles) and Part A's planning
    settings, cut as phase 6 is. Gates: no kernel launched; the final validation NLL below
    the random model's on the same split and stats; ``val_calibration_ratio`` finite and in
    the writer after every ``train()``; the bounds moved; the checkpoint bit for bit with its
    bounds and their Adam state; resume continues; a trained ``act()`` waits at most twice."""
    import tempfile

    import numpy as np
    import torch

    from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MetricsWriter,
                                    learn_dynamics_iteratively_w_mpc)
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.models.analytic import pendulum_reward
    from blackbox_mpc_torch.models.dynamics import map_params

    label = "MBRL PETS"
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, **{
        k: v for k, v in PETS_NET.items() if k not in ("dim_s", "dim_u")},
        **PETS_DRIVES["ts_inf"])
    solver = dict(PETS_SOLVER, rollout_backend="eager", seed=0)
    env = NativePendulumVecEnv(num_envs=MBRL["num_envs"], seed=0,
                               max_episode_steps=MBRL["episode_steps"])
    writer = MetricsWriter()
    handler = DynamicsHandler(config, seed=0, device=device, metrics_writer=writer)
    initial = map_params(torch.clone, handler.dynamics_params.params)
    trains = []
    train = handler.train

    def timed_train(*args, **kwargs):
        t0 = time.perf_counter()
        metrics = train(*args, **kwargs)
        trains.append({"train_s": time.perf_counter() - t0, "epochs": metrics["epochs_ran"],
                       "val_loss": metrics["val_loss"],
                       "val_calibration_ratio": metrics.get("val_calibration_ratio")})
        return metrics

    handler.train = timed_train
    with tempfile.TemporaryDirectory(prefix="pets_") as ckpt:
        counters = launch_counters()
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        with plain_rng_on_cuda() as plain_calls:
            handler, policy = learn_dynamics_iteratively_w_mpc(
                env, pendulum_reward, number_of_initial_rollouts=MBRL["initial_rollouts"],
                number_of_rollouts_per_refinement=1,
                number_of_refinement_steps=MBRL["refinements"],
                rollout_horizon=MBRL["episode_steps"], handler=handler,
                epochs=MBRL["epochs"], batch_size=MBRL["batch_size"],
                metrics_writer=writer, checkpoint_dir=ckpt, device=device, **solver)
        loop_s = time.perf_counter() - t0
        launches = {name: wrapper.launches for name, wrapper in counters.items()}
        if any(launches.values()) or any(plain_calls.values()):
            raise AssertionError(f"{label}: kernels launched {launches}, plain RNG on CUDA "
                                 f"{plain_calls}")
        final_val = float(np.mean(handler.validation_losses(handler.dynamics_params.params)))
        initial_val = float(np.mean(handler.validation_losses(initial)))
        if not final_val < initial_val:
            raise AssertionError(f"{label}: validation NLL {final_val} not below the random "
                                 f"model's {initial_val}")
        ratios = [v for _, v in writer.history.get("system_model/val_calibration_ratio", [])]
        if len(ratios) != 1 + MBRL["refinements"] or not np.all(np.isfinite(ratios)):
            raise AssertionError(f"{label}: val_calibration_ratio written {ratios}")
        final = handler.dynamics_params.params
        moved = {name: not torch.equal(final[name], initial[name].to(final[name].device))
                 for name in ("lv_min", "lv_max")}
        if not all(moved.values()):
            raise AssertionError(f"{label}: the logvar bounds did not move: {moved}")
        taken = handler.replay.arrays()[1]
        if not (np.isfinite(taken).all() and np.abs(taken).max() <= 2.0):
            raise AssertionError(f"{label}: an action was not finite or out of bounds")
        written_in_jax_format(ckpt, handler, None, label)
        loaded = DynamicsHandler.load(f"{ckpt}/handler", device=device)
        checkpoint_matches(handler, loaded)  # the bounds and their Adam state included
        obs = env.reset()
        resumed, _ = learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, number_of_refinement_steps=MBRL["refinements"] + 1,
            rollout_horizon=MBRL_RESUME_STEPS, epochs=1, batch_size=MBRL["batch_size"],
            checkpoint_dir=ckpt, resume=True, device=device, **solver)
        with open(f"{ckpt}/loop_state.json") as f:
            completed = json.load(f)["completed_refinements"]
        grown = len(resumed.replay) - len(loaded.replay)
        if (completed, grown) != (MBRL["refinements"] + 1,
                                  MBRL_RESUME_STEPS * MBRL["num_envs"]):
            raise AssertionError(f"{label}: resume ran to {completed} refinements and added "
                                 f"{grown} transitions")
        written_in_jax_format(ckpt, resumed, None, f"{label}, resumed")
        trace = trace_act(policy, obs, f"{label}, trained")
        gate_waits(trace, f"{label}, trained")
    history = writer.history
    res = {
        "mbrl": "PETS eager", "card": nvidia_smi(), "loop_s": loop_s, "launches": launches,
        "val_nll": {"initial_random_model": initial_val, "final": final_val},
        "val_calibration_ratio": ratios,
        "logvar_bounds": {name: [float(final[name].min()), float(final[name].max())]
                          for name in ("lv_min", "lv_max")},
        "act_ms_p50": [1e3 * v for _, v in history["perf/act_latency_p50_s"]],
        "act_ms_p95": [1e3 * v for _, v in history["perf/act_latency_p95_s"]],
        "trains": trains, "checkpoint": "bit for bit", "resumed_at": MBRL["refinements"],
        "trained_act_stream_syncs": trace["stream_syncs"],
        "trained_act_device_idle_share": trace["device_idle_share"],
    }
    print(json.dumps(res), flush=True)
    res["handler"] = handler  # phase 9 calibrates it through the command line
    return res


# Phase 8: the rest of the solver registry and the POPLIN half. Part A at the configuration of
# benchmarks/cheetah_gradient_bc_300ep_run.jsonl line 1 (its checkpoint is
# benchmarks/ckpt_gradient_bc_300): HalfCheetah S=18, U=6, a 5-member 3x256 tanh Gaussian-head
# ensemble, mean, H=15, two agents, Gradient with 32 restarts and 20 Adam steps, a (64, 64)
# proposer; CEM-GD as cheetah_cemgd_run.jsonl line 1 (population 510, 5 iterations, 50 elites,
# the GD defaults). Seeded weights, made-up stats.
GBC_NET = dict(PETS_NET, propagation="mean")
GBC_HORIZON, GBC_AGENTS = 15, 2
FIRST_ORDER = {"Gradient": dict(population=32, max_iterations=20),
               "CEM-GD": dict(population=510, max_iterations=ITERS, num_elite=50)}
BC_HIDDEN = (64, 64)
# remat against plain: the same operations computed again, relative to max |plain gradient|.
REMAT_TOLERANCE = 1e-6
# One adam_polish on the card, at each plan it visits: the gradient of the return, card against
# CPU, relative to its largest element (backpropagation through 15 model steps: float32
# differences grow with the model's expansion, 1.0e-4 measured against JAX on the CPU for the
# committed checkpoint's model); Adam's update from the same gradient, absolute (at most a few
# lr = 0.1).
POLISH_GRAD_TOLERANCE, ADAM_TOLERANCE = 1e-3, 1e-6
# Part B: PSO and SPSA on "kernel" at the flagship, K2 rows per launch.
KERNEL_SOLVERS = {"PSO": ROWS, "SPSA": 2 * ROWS}
# Part C: the pipeline on fused CEM at the flagship width on the native pendulum; the padded
# env's step time.
PIPE_STEPS, PAD_MS = 10, 40.0


def first_order_drives(device) -> dict:
    """Part A: ``act()`` of Gradient (with and without a proposer) and CEM-GD on ``"eager"``:
    each ``act()`` median, no kernel launched, one traced ``act()`` waiting at most twice;
    ``"kernel"`` and ``"fused"`` refuse both solvers; remat on and off give the gradients
    within REMAT_TOLERANCE, with each's peak memory; one ``adam_polish`` on the card, held
    against the CPU at every plan it visits: the gradients within POLISH_GRAD_TOLERANCE and
    Adam's updates from the same gradients within ADAM_TOLERANCE."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.learning.proposer import PolicyProposer, ProposerConfig
    from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
    from blackbox_mpc_torch.solvers.base import AdamState, adam_polish, adam_update

    config = LearnedDynamicsConfig(**GBC_NET)
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(pets_params(config, device))
    space = BoxSpace.of(-1.0, 1.0, dim=config.dim_u)
    bounds = Bounds.from_space(space)
    proposer = PolicyProposer(ProposerConfig(dim_s=config.dim_s, dim_u=config.dim_u,
                                             hidden=BC_HIDDEN), bounds, seed=0, device=device)

    def policy(name, backend="eager", **kw):
        return MPCPolicy(space, cheetah_reward, handler, solver_name=name,
                         num_agents=GBC_AGENTS, planning_horizon=GBC_HORIZON,
                         rollout_backend=backend, seed=0, device=device, **FIRST_ORDER[name],
                         **kw)

    res = {"first_order": "eager", "card": nvidia_smi(), "refusals": {}, "drives": {}}
    for name in FIRST_ORDER:
        for backend, words in (("kernel", "no VJP"), ("fused", "solver family")):
            try:
                policy(name, backend)
            except ValueError as err:
                if words not in str(err):
                    raise AssertionError(f"{name} on {backend!r}: refused for another reason: "
                                         f"{err}") from err
                res["refusals"][f"{name} {backend}"] = str(err)
            else:
                raise AssertionError(f"{name}: rollout_backend={backend!r} did not refuse")
    obs = np.zeros((GBC_AGENTS, config.dim_s), np.float32)
    for label, pol in (("Gradient", policy("Gradient")),
                       ("Gradient + proposer", policy("Gradient", proposer=proposer)),
                       ("CEM-GD", policy("CEM-GD"))):
        pol.act(obs)  # warm-up
        times, launches, plain_calls, (_, nxt, _) = timed_acts(pol, obs, STEPS, label)
        if any(launches.values()) or any(plain_calls.values()):
            raise AssertionError(f"{label}: kernels launched {launches}; the first-order path "
                                 "launches none")
        trace = trace_act(pol, nxt, label)
        gate_waits(trace, label)
        res["drives"][label] = {
            "act_ms": times, "act_ms_median": float(np.median(times)), "launches": launches,
            "stream_syncs": trace["stream_syncs"], "device_idle_share": trace["device_idle_share"],
            "device_ops": trace["device_ops"], "traced_act_window_us": trace["act_window_us"]}

    # remat: the gradient of the Gradient solver's objective over its restarts' shape.
    dp, dyn = handler.dynamics_params, handler.dynamics_fn
    g = torch.Generator(device=device).manual_seed(5)
    restarts = FIRST_ORDER["Gradient"]["population"]
    plans = torch.rand((restarts, GBC_AGENTS, GBC_HORIZON, config.dim_u), generator=g,
                       device=device) * 1.8 - 0.9
    s0 = torch.randn((GBC_AGENTS, config.dim_s), generator=g, device=device)
    grads, peak = {}, {}
    for remat in (False, True):
        evaluate = make_trajectory_evaluator(lambda s, a: dyn(dp, s, a), cheetah_reward,
                                             remat=remat, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        leaf = plans.clone().requires_grad_(True)
        (grads[remat],) = torch.autograd.grad(-evaluate(s0, leaf).mean(), leaf)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated(device) - held
    err = float((grads[True] - grads[False]).abs().max())
    scale = float(grads[False].abs().max())
    if not (scale > 0 and err <= REMAT_TOLERANCE * scale):
        raise AssertionError(f"remat gradients differ: {err} > {REMAT_TOLERANCE} * {scale}")
    res["remat"] = {"rows": restarts * GBC_AGENTS, "grad_rel_err": err / scale,
                    "peak_bytes_plain": peak[False], "peak_bytes_remat": peak[True]}

    # One adam_polish (the Gradient solver's 20 steps at its learning rate) on the card. At each
    # plan it visits, the gradient of the return on the card and on the CPU, and Adam's update
    # from the same gradients on both; the whole step and the free-running result are printed:
    # Adam divides each gradient by its own running scale, so an element whose gradient is small
    # beside the terms summed into it turns their rounding into a relative error of its update
    # (a step differed by 1.9e-4 of max(1, max|plan|) in the second chip run of this phase).
    lr, steps = 0.1, FIRST_ORDER["Gradient"]["max_iterations"]
    cpu = torch.device("cpu")
    evaluate_on = {where: make_trajectory_evaluator(lambda s, a, p=params: dyn(p, s, a),
                                                    cheetah_reward, device=on)
                   for where, on, params in (("card", device, dp), ("cpu", cpu, dp.to(cpu)))}
    points = []

    def card_objective(p):
        points.append(p.detach().clone())
        return evaluate_on["card"](s0, p)

    t0 = time.perf_counter()
    polished = adam_polish(card_objective, bounds, lr, plans, steps)
    torch.cuda.synchronize()
    res["polish_card_s"] = time.perf_counter() - t0
    if not bool(torch.isfinite(polished).all()):
        raise AssertionError("adam_polish on the card: plans not finite")
    states = {where: AdamState.zeros_like([plans.to(on)]) for where, on in (("card", device),
                                                                             ("cpu", cpu))}
    worst = {"grad": 0.0, "update": 0.0, "step": 0.0}
    for k, here in enumerate(points):
        grads = {}
        for where, on in (("card", device), ("cpu", cpu)):
            leaf = here.to(on).requires_grad_(True)
            (grads[where],) = torch.autograd.grad(
                -evaluate_on[where](s0.to(on), leaf).mean(), leaf)
        want = grads["cpu"]
        worst["grad"] = max(worst["grad"], float((grads["card"].cpu() - want).abs().max())
                            / float(want.abs().max()))
        updates = {}
        for where, on in (("card", device), ("cpu", cpu)):
            states[where], (updates[where],) = adam_update(states[where], [want.to(on)], lr)
        worst["update"] = max(worst["update"],
                              float((updates["card"].cpu() - updates["cpu"]).abs().max()))
        nxt = points[k + 1] if k + 1 < len(points) else polished
        step = bounds.clip(here.cpu() + updates["cpu"])
        worst["step"] = max(worst["step"], float((nxt.cpu() - step).abs().max())
                            / max(1.0, float(step.abs().max())))
    res["polish_card_vs_cpu"] = {"grad_rel_err": worst["grad"],
                                 "update_abs_err": worst["update"],
                                 "step_rel_err": worst["step"]}
    if worst["grad"] > POLISH_GRAD_TOLERANCE or worst["update"] > ADAM_TOLERANCE:
        raise AssertionError(f"adam_polish card vs CPU: {res['polish_card_vs_cpu']}")
    free = adam_polish(lambda p: evaluate_on["cpu"](s0.cpu(), p), bounds, lr, plans.cpu(), steps)
    res["polish_card_vs_cpu"]["free_running_abs_err"] = float((free - polished.cpu()).abs().max())
    print(json.dumps(res), flush=True)
    return res


def kernel_solver_drives(device) -> dict:
    """Part B: PSO and SPSA on ``"kernel"`` at the flagship (K2 once per iteration at 1000
    and 2000 rows, nothing else; at most two waits), K2 against its plain version on an SPSA
    2P batch; fused CEM seeded by a proposer (K4 and K6 as without it; the unroll's host
    time); CEM on ``"eager"`` time-major against the standard layout."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.learning.proposer import PolicyProposer, ProposerConfig
    from blackbox_mpc_torch.ops import rollout_kernel as rk
    from blackbox_mpc_torch.solvers.spsa import rademacher

    config = LearnedDynamicsConfig(**FLAGSHIP, propagation="mean")
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(flagship_params(config, device))
    space = BoxSpace.of(-1.0, 1.0, dim=config.dim_u)
    obs = np.zeros(config.dim_s, np.float32)

    def policy(name, backend, **kw):
        return MPCPolicy(space, reward_fn, handler, solver_name=name, rollout_backend=backend,
                         planning_horizon=HORIZON, population=ROWS, max_iterations=ITERS, seed=0,
                         device=device, **kw)

    res = {"kernel_solvers": "flagship", "card": nvidia_smi(), "drives": {}}
    for name, rows in KERNEL_SOLVERS.items():
        pol = policy(name, "kernel")
        pol.act(obs)  # warm-up
        times, launches, plain_calls, (_, nxt, _) = timed_acts(pol, obs, STEPS, name)
        expected = {k: STEPS * ITERS if k == "rollout_states" else 0 for k in launches}
        if launches != expected or any(plain_calls.values()):
            raise AssertionError(f"{name}: kernel launches {launches}, expected {expected}")
        launched_rows = []
        counted = rk.rollout_states

        def spy(config_, ops, acts, s0, member, counted=counted):
            launched_rows.append(acts.shape[1])
            return counted(config_, ops, acts, s0, member)

        spy.launches = 0  # the wrapper counts through its module name, here the spy
        rk.rollout_states = spy
        try:
            pol.act(nxt)
        finally:
            rk.rollout_states = counted
        padded = -(-rows // rk.TILE_MEAN) * rk.TILE_MEAN
        if launched_rows != [padded] * ITERS:
            raise AssertionError(f"{name}: K2 launched on {launched_rows} rows, expected "
                                 f"{ITERS} x {padded} ({rows} padded to the tile)")
        trace = trace_act(pol, nxt, name)
        gate_waits(trace, name)
        res["drives"][name] = {
            "act_ms": times, "act_ms_median": float(np.median(times)), "launches": launches,
            "k2_rows": rows, "stream_syncs": trace["stream_syncs"],
            "device_idle_share": trace["device_idle_share"], "device_ops": trace["device_ops"]}

    # K2 on SPSA's first 2P batch: the midpoint (0) plus and minus c_0 * Rademacher, clipped.
    g = torch.Generator(device=device).manual_seed(3)
    delta = rademacher(g, (HORIZON, ROWS, config.dim_u))
    batch = torch.cat([(0.3 * delta).clamp(-1, 1), (-0.3 * delta).clamp(-1, 1)], dim=1)
    s0 = torch.randn((2 * ROWS, config.dim_s), generator=g, device=device)
    res["k2_spsa_batch"] = kernel_vs_plain(device, "mean", "float32",
                                           inputs=(batch.contiguous(), s0),
                                           label=" (SPSA 2P batch)")

    # Fused CEM seeded by a proposer.
    bounds = Bounds.from_space(space)
    proposer = PolicyProposer(ProposerConfig(dim_s=config.dim_s, dim_u=config.dim_u,
                                             hidden=BC_HIDDEN), bounds, seed=0, device=device)
    label = "fused CEM + proposer"
    pol = policy("CEM", "fused", num_elite=50, proposer=proposer)
    pol.act(obs)
    times, launches, plain_calls, (_, nxt, _) = timed_acts(pol, obs, STEPS, label)
    expected = {k: STEPS * BACKEND_KERNELS["fused"].get(k, 0) for k in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    trace = trace_act(pol, nxt, label, per_act=BACKEND_KERNELS["fused"])
    gate_waits(trace, label)
    obs_dev = torch.zeros((1, config.dim_s), device=device)
    torch.cuda.synchronize()
    host = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        pol._propose(proposer.params, handler.dynamics_params, obs_dev)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    res["drives"][label] = {
        "act_ms": times, "act_ms_median": float(np.median(times)), "launches": launches,
        "stream_syncs": trace["stream_syncs"], "device_idle_share": trace["device_idle_share"],
        "unroll_host_ms": host, "unroll_host_ms_median": float(np.median(host))}

    # CEM on "eager": time-major against the standard layout.
    for tm in (False, True):
        label = "eager CEM" + (", time-major" if tm else "")
        pol = policy("CEM", "eager", num_elite=50, time_major=tm)
        pol.act(obs)
        times, launches, _, _ = timed_acts(pol, obs, STEPS, label)
        if any(launches.values()):
            raise AssertionError(f"{label}: kernels launched {launches}")
        res["drives"][label] = {"act_ms": times, "act_ms_median": float(np.median(times))}
    print(json.dumps(res), flush=True)
    return res


class PaddedEnv:
    """An env whose step takes ``step_s`` seconds of host time: the wrapped env's step, then a
    sleep in ``step_wait`` up to ``step_s`` from ``step_async``."""

    def __init__(self, env, step_s: float):
        self._env, self._step_s, self._t0 = env, step_s, 0.0
        self.num_envs = env.num_envs
        self.action_space, self.observation_space = env.action_space, env.observation_space

    def reset(self):
        return self._env.reset()

    def step_async(self, actions):
        self._t0 = time.perf_counter()
        self._env.step_async(actions)

    def step_wait(self):
        out = self._env.step_wait()
        time.sleep(max(0.0, self._step_s - (time.perf_counter() - self._t0)))
        return out

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()


class PipelinedAct:
    """``act(obs)`` of a speculative pipeline at consecutive steps, for ``trace_act``."""

    def __init__(self, pipe, t: int):
        self._pipe, self._t = pipe, t

    def act(self, obs, exploration_noise: bool = False):
        self._t += 1
        return self._pipe.act(obs, self._t)[:3]


def pipeline_runs(device) -> dict:
    """Part C: the speculative pipeline on fused CEM at the flagship width (5 x 3x500, CEM
    population 1000, H=50) on the native pendulum with two agents. Gates: ``spec_tol=None``
    gives the bits of the synchronous per-step-seeded run, so does ``spec_tol=0`` (every step
    a miss); K4 and K6 launch once per iteration of every solve, speculative and exact; one
    traced pipelined step waits at most twice. Printed: the hit rate and the wall time per
    step with overlap off and on, on the native env and on one padded to PAD_MS."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MPCPolicy,
                                    perform_rollouts)
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.models.analytic import pendulum_reward
    from blackbox_mpc_torch.policies.pipeline import SpeculativePipeline

    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=FLAGSHIP["hidden"],
                                   ensemble_size=FLAGSHIP["ensemble_size"], propagation="mean")
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(flagship_params(config, device))

    def env(steps=PIPE_STEPS):
        return NativePendulumVecEnv(num_envs=MBRL["num_envs"], seed=0, max_episode_steps=steps)

    def policy():
        return MPCPolicy(env().action_space, pendulum_reward, handler, solver_name="CEM",
                         rollout_backend="fused", num_agents=MBRL["num_envs"],
                         planning_horizon=HORIZON, population=ROWS, num_elite=50,
                         max_iterations=ITERS, seed=0, device=device)

    def synchronous():
        pol, e = policy(), env()
        pipe = SpeculativePipeline(pol, spec_tol=None)
        pipe.reset()  # the episode seed, as the pipelined runs draw it
        obs, actions = e.reset(), []
        for t in range(PIPE_STEPS):
            action, pol._solver_state, _, _, _ = pol._step(
                pol._solver_state, torch.as_tensor(obs, device=device), t,
                *pipe.step_generators(t), False)
            actions.append(action.cpu().numpy())
            obs = e.step(actions[-1])[0]
        return actions

    def pipelined(tol):
        pipe, e = SpeculativePipeline(policy(), spec_tol=tol), env()
        pipe.reset()
        obs, actions = e.reset(), []
        for t in range(PIPE_STEPS):
            actions.append(pipe.act(obs, t)[0])
            e.step_async(actions[-1])
            obs = e.step_wait()[0]
        return actions, pipe

    exact = synchronous()
    prefetch, _ = pipelined(None)
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    with plain_rng_on_cuda() as plain_calls:
        missed, pipe = pipelined(0.0)
    launches = {name: wrapper.launches for name, wrapper in counters.items()}
    for label, actions in (("spec_tol=None", prefetch), ("spec_tol=0 (every step a miss)", missed)):
        if not all(same_bits(a, b) for a, b in zip(actions, exact)):
            raise AssertionError(f"pipeline {label}: actions differ from the synchronous "
                                 "per-step-seeded run")
    if (pipe.hits, pipe.misses) != (0, PIPE_STEPS - 1):
        raise AssertionError(f"pipeline spec_tol=0: {pipe.hits} hits, {pipe.misses} misses")
    solves = PIPE_STEPS + PIPE_STEPS  # one speculation per step; an exact solve per step
    expected = {name: solves * BACKEND_KERNELS["fused"].get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"pipeline: kernel launches {launches}, expected {expected}")
    res = {"pipeline": "fused CEM, flagship width, pendulum", "card": nvidia_smi(),
           "bit_for_bit": ["spec_tol=None", "spec_tol=0"], "launches_20_solves": launches}

    pol = policy()
    pol.act(env().reset())  # warm-up
    runs = {}
    for env_label, make in (("native", env), (f"padded to {PAD_MS} ms",
                                              lambda: PaddedEnv(env(), PAD_MS / 1e3))):
        for mode, overlap, tol in (("sync", False, None), ("overlap, spec_tol 0.05", True, 0.05),
                                   ("overlap, every step adopted", True, float("inf"))):
            t0 = time.perf_counter()
            out = perform_rollouts(make(), pol, rollout_horizon=PIPE_STEPS, overlap=overlap,
                                   spec_tol=tol)
            runs[f"{env_label}, {mode}"] = {
                "ms_per_step": (time.perf_counter() - t0) * 1e3 / PIPE_STEPS,
                "act_ms_p50": out["latency"]["p50_s"] * 1e3,
                "spec_hit_rate": out["spec_hit_rate"]}
    res["runs"] = runs
    pipe = SpeculativePipeline(pol, spec_tol=float("inf"))
    pipe.reset()
    obs = env().reset()
    for t in range(2):  # warm-up: a speculation in flight
        pipe.act(obs, t)
    trace = trace_act(PipelinedAct(pipe, 1), obs, "pipelined step, fused CEM")
    waits = trace["stream_syncs"] + trace["event_syncs"]
    if waits > MAX_SYNCS:
        raise AssertionError(f"pipelined step: {waits} waits, more than {MAX_SYNCS}")
    res["pipelined_step"] = {"stream_syncs": trace["stream_syncs"],
                             "event_syncs": trace["event_syncs"],
                             "device_idle_share": trace["device_idle_share"]}
    print(json.dumps(res), flush=True)
    return res


def bc_loop(device) -> dict:
    """Part D: phase 6's loop on ``"fused"`` with ``behavior_cloning=True, overlap=True``.
    Gates: every behaviour-cloning ``train()`` lowers the proposer's error on the replay; K4
    and K6 launch alike, a whole number of solves, nothing else; the checkpoint holds the
    handler and the proposer bit for bit and ``resume=True`` restores both."""
    import tempfile

    import numpy as np

    from blackbox_mpc_torch import (DynamicsHandler, LearnedDynamicsConfig, MetricsWriter,
                                    learn_dynamics_iteratively_w_mpc)
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.learning.proposer import PolicyProposer
    from blackbox_mpc_torch.models.analytic import pendulum_reward

    label = "MBRL fused + BC + overlap"
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=FLAGSHIP["hidden"],
                                   ensemble_size=FLAGSHIP["ensemble_size"], propagation="mean")
    solver = dict(solver_name="CEM", planning_horizon=HORIZON, population=ROWS, num_elite=50,
                  max_iterations=ITERS, rollout_backend="fused", seed=0)
    loop = dict(number_of_rollouts_per_refinement=1, rollout_horizon=MBRL["episode_steps"],
                epochs=MBRL["epochs"], batch_size=MBRL["batch_size"], behavior_cloning=True,
                bc_hidden=BC_HIDDEN, overlap=True, device=device, **solver)
    env = NativePendulumVecEnv(num_envs=MBRL["num_envs"], seed=0,
                               max_episode_steps=MBRL["episode_steps"])
    writer = MetricsWriter()
    bc = []
    train = PolicyProposer.train

    def measured_train(self, replay, *args, **kwargs):
        s, a, _ = replay.arrays(validation=False)
        a = np.clip(a, self.bounds.lower, self.bounds.upper)
        before = float(np.mean(np.square(self.act(s) - a)))
        t0 = time.perf_counter()
        out = train(self, replay, *args, **kwargs)
        after = float(np.mean(np.square(self.act(s) - a)))
        bc.append({"mse_before": before, "mse_after": after, "bc_loss": out["bc_loss"],
                   "pairs": out["num_pairs"], "train_s": time.perf_counter() - t0})
        return out

    with tempfile.TemporaryDirectory(prefix="bc_") as ckpt:
        counters = launch_counters()
        for wrapper in counters.values():
            wrapper.launches = 0
        PolicyProposer.train = measured_train
        try:
            t0 = time.perf_counter()
            handler, policy = learn_dynamics_iteratively_w_mpc(
                env, pendulum_reward, number_of_initial_rollouts=MBRL["initial_rollouts"],
                number_of_refinement_steps=MBRL["refinements"], metrics_writer=writer,
                checkpoint_dir=ckpt, handler=DynamicsHandler(config, seed=0, device=device),
                **loop)
            loop_s = time.perf_counter() - t0
        finally:
            PolicyProposer.train = train
        launches = {name: wrapper.launches for name, wrapper in counters.items()}
        k4 = launches["fused_rollout"]
        if (k4 == 0 or k4 % ITERS or launches["elite_moments"] != k4
                or any(n for name, n in launches.items()
                       if name not in ("fused_rollout", "elite_moments"))):
            raise AssertionError(f"{label}: kernel launches {launches}")
        if len(bc) != 1 + MBRL["refinements"] or not all(
                b["mse_after"] < b["mse_before"] for b in bc):
            raise AssertionError(f"{label}: behaviour cloning did not lower the error: {bc}")
        written = [v for _, v in writer.history.get("proposer/bc_loss", [])]
        if len(written) != MBRL["refinements"] or not np.all(np.isfinite(written)):
            raise AssertionError(f"{label}: proposer/bc_loss written {written}")
        written_in_jax_format(ckpt, handler, policy.proposer, label)
        current = policy.proposer.state_dict()
        loaded = DynamicsHandler.load(f"{ckpt}/handler", device=device)
        checkpoint_matches(handler, loaded)
        resumed_handler, resumed = learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, number_of_refinement_steps=MBRL["refinements"],
            checkpoint_dir=ckpt, resume=True, **loop)
        checkpoint_matches(handler, resumed_handler)
        again = resumed.proposer.state_dict()
        if again["adam"]["step"] != current["adam"]["step"] or not all(
                same_bits(x, y) for x, y in zip(
                    [v for layer in again["params"] for v in layer.values()]
                    + again["adam"]["exp_avg"] + again["adam"]["exp_avg_sq"],
                    [v for layer in current["params"] for v in layer.values()]
                    + current["adam"]["exp_avg"] + current["adam"]["exp_avg_sq"])):
            raise AssertionError(f"{label}: the resumed proposer differs")
    history = writer.history
    res = {"mbrl": label, "card": nvidia_smi(), "loop_s": loop_s, "launches": launches,
           "behaviour_cloning": bc, "bc_loss_written": written,
           "act_ms_p50": [1e3 * v for _, v in history["perf/act_latency_p50_s"]],
           "spec_hit_rate": [v for _, v in history.get("perf/spec_hit_rate", [])],
           "checkpoint": "bit for bit, proposer included", "resumed": "bit for bit"}
    print(json.dumps(res), flush=True)
    return res



# Phase 9: the single-card entry points. Part A times act() on "eager" and "kernel" at H=50 over
# these populations and hidden widths (S=17, U=6, E=5, mean, f32), the grid behind
# ops/backend_select.py's constants, and measures the peak memory per candidate row of the
# "kernel" and "eager" paths, each at two populations, for FUSED_MIN_BYTES.
SWEEP_POPULATIONS = (100, 300, 1000, 3000, 10000)
SWEEP_HIDDEN = ((64, 64), (500, 500, 500))
SWEEP_STEPS = 3
# FUSED_MIN_BYTES puts the peak of the path that runs below it at this share of the card's
# memory. Peak memory per row is measured on "kernel" at these populations (up to
# KERNEL_MAX_ROWS) and on "eager" at the two above it (what "auto" runs up to the threshold).
FUSED_MEMORY_SHARE = 0.5
KERNEL_PEAK_POPULATIONS = (1000, 3000)
EAGER_PEAK_POPULATIONS = (20000, 60000)
EPISODE_STEPS = 20  # Part B's device-resident episodes
# Part C's export: the flagship CEM (H=50, population 1000, 5 iterations) at this horizon.
EXPORT_HORIZON = HORIZON


def zero_launches() -> dict:
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    return counters


def read_launches(counters: dict) -> dict:
    return {name: wrapper.launches for name, wrapper in counters.items()}


def flagship_handler(device, hidden=FLAGSHIP["hidden"]):
    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig

    config = LearnedDynamicsConfig(**{**FLAGSHIP, "hidden": hidden}, propagation="mean")
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(flagship_params(config, device))
    return handler


def flagship_policy(device, handler, backend: str, population: int = ROWS, **kw):
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    kw = {"planning_horizon": HORIZON, "max_iterations": ITERS, **kw}
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=6), reward_fn, handler, solver_name="CEM",
                     rollout_backend=backend, population=population, num_elite=50,
                     seed=0, device=device, **kw)


def act_peak_bytes(policy, obs) -> int:
    """The peak memory of one ``act()`` above what the process held before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    policy.act(obs)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def fused_threshold(device, handler) -> dict:
    """The capacity threshold ``FUSED_MIN_BYTES``: the peak memory per candidate row of
    ``"kernel"`` (1000 and 3000 rows) and of ``"eager"`` (20 000 and 60 000 rows, above
    ``KERNEL_MAX_ROWS``, where ``auto`` runs eager up to the threshold), each from the growth
    between its two populations, and the candidate size at which the larger puts the peak at
    FUSED_MEMORY_SHARE of the card. Gate: the largest population that ``auto`` sends to eager
    under the committed constant runs, with a one-iteration ``act()`` (the peak is one
    iteration's), at a peak within the card's memory."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.ops import backend_select

    smi = nvidia_smi()
    obs = np.zeros(17, np.float32)
    candidate_row = HORIZON * 6 * 4
    total = torch.cuda.get_device_properties(0).total_memory
    peaks, per_byte = {}, {}
    for backend, populations in (("kernel", KERNEL_PEAK_POPULATIONS),
                                 ("eager", EAGER_PEAK_POPULATIONS)):
        peaks[backend] = {}
        for population in populations:
            # The eager loop's own peak, as it runs near the threshold: there an evaluation's
            # working memory is past GRAPH_MAX_MEMORY_SHARE and no CUDA graph is captured.
            with eager_loop():
                policy = flagship_policy(device, handler, backend, population)
                policy.act(obs)  # warm-up
                peaks[backend][population] = act_peak_bytes(policy, obs)
            del policy
        low, high = populations
        per_row = (peaks[backend][high] - peaks[backend][low]) / (high - low)
        per_byte[backend] = per_row / candidate_row
    threshold = FUSED_MEMORY_SHARE * total / max(per_byte.values())
    rows = backend_select.FUSED_MIN_BYTES // candidate_row - 1
    resolved = backend_select.choose_backend(handler.config, rows, 1, platform="cuda",
                                             horizon=HORIZON, dim_u=6, solver_name="CEM")
    if resolved != "eager":
        raise AssertionError(f"auto at {rows} rows resolved to {resolved!r}, expected 'eager'")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    edge = act_peak_bytes(flagship_policy(device, handler, "eager", rows, max_iterations=1), obs)
    edge_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if edge >= total:
        raise AssertionError(f"eager at {rows} rows peaked at {edge} bytes of {total}")
    memory = {"peak_bytes": peaks, "peak_per_candidate_byte": per_byte,
              "candidate_bytes_per_row": candidate_row, "total_memory": total,
              "share": FUSED_MEMORY_SHARE, "fused_min_bytes_measured": threshold,
              "FUSED_MIN_BYTES": backend_select.FUSED_MIN_BYTES,
              "largest_eager_rows": rows, "largest_eager_peak_bytes": edge,
              "largest_eager_peak_share": edge / total, "largest_eager_act_s": edge_s,
              "KERNEL_MAX_WIDTH": backend_select.KERNEL_MAX_WIDTH,
              "KERNEL_MAX_ROWS": backend_select.KERNEL_MAX_ROWS}
    print(json.dumps({"auto_memory": memory, "card": smi}), flush=True)
    return memory


def act_ms(policy, obs, steps: int = SWEEP_STEPS) -> list:
    policy.act(obs)  # warm-up
    times = []
    for t in range(steps):
        t0 = time.perf_counter()
        policy.act(obs, t)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def auto_backend(device) -> dict:
    """Part A: the sweep, the memory per row, and ``"auto"`` at the flagship: it must resolve
    to ``"kernel"`` with the explicit backend's bits (K2 five times an ``act()``), and with
    ``FUSED_MIN_BYTES`` lowered to ``"fused"`` with that backend's bits (K4 and K6 five times
    each)."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.ops import backend_select

    smi = nvidia_smi()
    obs = np.zeros(17, np.float32)
    table = []
    for hidden in SWEEP_HIDDEN:
        handler = flagship_handler(device, hidden)
        for population in SWEEP_POPULATIONS:
            row = {"hidden": list(hidden), "population": population}
            for backend in ("eager", "kernel"):
                times = act_ms(flagship_policy(device, handler, backend, population), obs)
                row[f"{backend}_ms"] = float(np.median(times))
            row["kernel_speedup"] = row["eager_ms"] / row["kernel_ms"]
            table.append(row)
            print(json.dumps({"auto_sweep": row, "card": smi}), flush=True)
    handler = flagship_handler(device)
    memory = fused_threshold(device, handler)

    def same_bits_as(explicit: str, label: str) -> dict:
        auto = flagship_policy(device, handler, "auto")
        if auto.rollout_backend != explicit:
            raise AssertionError(f"{label}: auto resolved to {auto.rollout_backend!r}, "
                                 f"expected {explicit!r}")
        ref = flagship_policy(device, handler, explicit)
        counters = zero_launches()
        got = [auto.act(obs, t)[0] for t in range(STEPS)]
        launches = read_launches(counters)
        want = [ref.act(obs, t)[0] for t in range(STEPS)]
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: auto's actions differ from {explicit!r}'s")
        expected = {name: STEPS * BACKEND_KERNELS[explicit].get(name, 0) for name in launches}
        if launches != expected:
            raise AssertionError(f"{label}: launches {launches}, expected {expected}")
        return launches

    kernel = same_bits_as("kernel", "auto at the flagship")
    lowered, backend_select.FUSED_MIN_BYTES = backend_select.FUSED_MIN_BYTES, 1
    try:
        fused = same_bits_as("fused", "auto with FUSED_MIN_BYTES lowered to 1")
    finally:
        backend_select.FUSED_MIN_BYTES = lowered
    res = {"auto_table": table, "memory": memory, "auto_kernel_launches": kernel,
           "auto_fused_launches": fused, "card": smi}
    print(json.dumps({"auto": "kernel and fused bits as explicit", "launches":
                      {"kernel": kernel, "fused": fused}}), flush=True)
    return res


def count_waits(fn) -> tuple:
    """``fn()`` under ``utils/profiling.py::trace``: (its result, the host's
    ``cudaStreamSynchronize`` calls, the device operations)."""
    import tempfile

    from torch.autograd import DeviceType

    from blackbox_mpc_torch.utils import profiling

    with tempfile.TemporaryDirectory() as log_dir, profiling.trace(log_dir) as prof:
        out = fn()
    events = profiled_events(prof)
    syncs = sum(1 for e in events if e.name == "cudaStreamSynchronize"
                and e.device_type == DeviceType.CPU)
    ops = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    return out, syncs, ops


def device_episodes(device) -> dict:
    """Part B: ``evaluate_solver_on_model`` for EPISODE_STEPS steps, the fused CEM over the
    flagship model as the env, and the eager CEM over the analytic pendulum. Gates: at most one
    ``cudaStreamSynchronize`` for the episode with its readback, finite rewards, K4 and K6
    five times a step (none for the eager one). Printed: ms per step against a host loop of
    ``act()`` on the same solver and model."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
    from blackbox_mpc_torch.ops.fused_cem import make_fused_cem
    from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
    from blackbox_mpc_torch.solvers import CEMConfig, make_cem
    from blackbox_mpc_torch.workflows import evaluate_solver_on_model

    smi = nvidia_smi()
    handler = flagship_handler(device)
    dp = handler.dynamics_params
    config = CEMConfig(planning_horizon=HORIZON, population=ROWS, num_elite=50,
                       max_iterations=ITERS)
    true = DynamicsHandler(true_model=pendulum_dynamics, device=device)
    drives = {
        "fused CEM, flagship model": (
            make_fused_cem(config, Bounds.of(-1.0, 1.0, dim=6), handler.config, dp, reward_fn),
            lambda s, a: handler.mean_dynamics_fn(dp, s, a), reward_fn, np.zeros(17, np.float32),
            {"fused_rollout": ITERS, "elite_moments": ITERS}, handler, BoxSpace.of(-1.0, 1.0,
                                                                                   dim=6)),
        "eager CEM, analytic pendulum": (
            make_cem(CEMConfig(planning_horizon=25, population=512, num_elite=50,
                               max_iterations=ITERS), Bounds.of(-2.0, 2.0, dim=1),
                     make_trajectory_evaluator(pendulum_dynamics, pendulum_reward,
                                               device=device)),
            pendulum_dynamics, pendulum_reward, np.array([-1.0, 0.0, 0.0], np.float32), {},
            true, BoxSpace.of(-2.0, 2.0, dim=1)),
    }
    res = {}
    for label, (solver, dynamics, reward, obs0, per_step, model, space) in drives.items():
        initial = torch.as_tensor(obs0[None], device=device)

        def episode(seed):
            generator = torch.Generator(device=device).manual_seed(seed)
            rewards, final, _ = evaluate_solver_on_model(solver, dynamics, reward, initial,
                                                         EPISODE_STEPS, generator)
            return torch.cat([rewards.reshape(-1), final.reshape(-1)]).cpu().numpy()

        episode(0)  # warm-up
        counters = zero_launches()
        t0 = time.perf_counter()
        out = episode(1)
        wall = time.perf_counter() - t0
        launches = read_launches(counters)
        (_, syncs, ops) = count_waits(lambda: episode(2))
        if syncs > 1:
            raise AssertionError(f"{label}: {syncs} cudaStreamSynchronize calls in one "
                                 "device-resident episode, more than 1 (the readback)")
        if not np.all(np.isfinite(out)):
            raise AssertionError(f"{label}: the episode's rewards or final obs are not finite")
        expected = {name: EPISODE_STEPS * per_step.get(name, 0) for name in launches}
        if launches != expected:
            raise AssertionError(f"{label}: launches {launches}, expected {expected}")
        # The host loop: MPCPolicy.act with the same solver settings, the model as the env.
        backend = "fused" if per_step else "eager"
        solver_kw = ({"planning_horizon": HORIZON, "population": ROWS} if per_step else
                     {"planning_horizon": 25, "population": 512})
        from blackbox_mpc_torch import MPCPolicy

        policy = MPCPolicy(space, reward, model, solver_name="CEM", rollout_backend=backend,
                           num_elite=50, max_iterations=ITERS, seed=0, device=device,
                           **solver_kw)
        obs = obs0
        policy.act(obs)
        t0 = time.perf_counter()
        for t in range(EPISODE_STEPS):
            _, obs, _ = policy.act(obs, t)
        host = time.perf_counter() - t0
        res[label] = {"device_episode_ms_per_step": 1e3 * wall / EPISODE_STEPS,
                      "host_loop_act_ms_per_step": 1e3 * host / EPISODE_STEPS,
                      "stream_syncs": syncs, "device_ops": ops, "launches": launches,
                      "episode_return": float(out[:EPISODE_STEPS].sum())}
        print(json.dumps({"device_episode": label, **res[label], "card": smi}), flush=True)
    return res


def serving_on_cuda(device, workdir: str) -> dict:
    """Part C: an eager CEM ``MPCPolicy`` at the flagship width, exported after one ``act()``
    and loaded as a ``ServingPolicy`` on the card, continues bit for bit for three ``act()``s
    (explore false, true, false) and a reset; swapped params act as a policy given the same
    params does; ``export_dynamics`` at two batch sizes against ``mean_dynamics_fn``. Printed:
    export and load seconds, and ``ServingPolicy.act`` beside ``MPCPolicy.act``."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.deploy import ServingPolicy, export_dynamics, export_policy_artifact
    from blackbox_mpc_torch.models.dynamics import map_params

    smi = nvidia_smi()
    obs = np.zeros(17, np.float32)
    path = f"{workdir}/flagship.bbmpc"

    def make(handler):
        return flagship_policy(device, handler, "eager", planning_horizon=EXPORT_HORIZON)

    policy = make(flagship_handler(device))
    policy.act(obs)  # mid-episode: the artifact resumes the state and the stream
    t0 = time.perf_counter()
    meta = export_policy_artifact(policy, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = ServingPolicy.load(path)
    load_s = time.perf_counter() - t0
    served = ServingPolicy.load(path)  # a second copy for the params swap
    for t, explore in ((1, False), (2, True), (3, False)):
        a = policy.act(obs, t, exploration_noise=explore)
        b = srv.act(obs, t, exploration_noise=explore)
        if not all(same_bits(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"serving: act(explore={explore}) differs from MPCPolicy's")
    policy.reset()
    srv.reset()
    if not same_bits(policy.act(obs)[0], srv.act(obs)[0]):
        raise AssertionError("serving: the first act() after reset differs")
    times = {"MPCPolicy": act_ms(policy, obs), "ServingPolicy": act_ms(srv, obs)}
    trace = trace_act(srv, obs, "served ServingPolicy")
    gate_waits(trace, "served ServingPolicy")
    # The params swap: a policy with the same history, given the new params.
    twin = make(flagship_handler(device))
    twin.act(obs)
    new = twin.dynamics_handler.dynamics_params
    new = new.replace(params=map_params(lambda v: v + 0.01, new.params))
    twin.dynamics_handler.set_params(new)
    served.update_dynamics_params(new)
    if not same_bits(twin.act(obs, 1)[0], served.act(obs, 1)[0]):
        raise AssertionError("serving: the swapped params act otherwise than MPCPolicy's")
    handler = policy.dynamics_handler
    program = export_dynamics(handler, f"{workdir}/dynamics.pt2").module()
    dyn_err = 0.0
    for b in (3, 257):
        g = np.random.default_rng(b)
        s = torch.as_tensor(g.normal(size=(b, 17)), dtype=torch.float32, device=device)
        a = torch.as_tensor(g.uniform(-1, 1, (b, 6)), dtype=torch.float32, device=device)
        with torch.no_grad():
            want = handler.mean_dynamics_fn(handler.dynamics_params, s, a)
            got = program(s, a)
        dyn_err = max(dyn_err, float((got - want).abs().max() / want.abs().max().clamp(min=1)))
    if dyn_err > 1e-6:
        raise AssertionError(f"export_dynamics differs from mean_dynamics_fn by {dyn_err}")
    import os

    res = {"serving": "bit for bit", "horizon": EXPORT_HORIZON, "export_s": export_s,
           "load_s": load_s, "artifact_bytes": os.path.getsize(path),
           "act_ms": {k: float(np.median(v)) for k, v in times.items()},
           "act_ms_all": times, "traced_act_stream_syncs": trace["stream_syncs"],
           "export_dynamics_rel_err": dyn_err, "draws": {
               k: len(v) for k, v in meta["draws"].items()}, "card": smi}
    print(json.dumps(res), flush=True)
    return res


def cli(args, stdin: str | None = None, timeout: int = 600) -> tuple:
    """``python -m blackbox_mpc_torch <args>`` from the repository root: (exit code, the JSON
    lines of its standard output, its standard error)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-m", "blackbox_mpc_torch", *args], input=stdin,
                         capture_output=True, text=True, timeout=timeout, cwd=root, env=env)
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    return out.returncode, lines, out.stderr


def cli_gate(name: str, rc: int, lines: list, stderr: str, keys=(), want_rc: int = 0):
    if rc != want_rc:
        raise AssertionError(f"cli {name}: exit code {rc}, expected {want_rc}: {stderr[-2000:]}")
    missing = [k for k in keys if not lines or k not in lines[-1]]
    if missing:
        raise AssertionError(f"cli {name}: the JSON line lacks {missing}: {lines[-1:]}")


def cli_on_card(device, workdir: str, trained, probabilistic) -> dict:
    """Part D: the command line on the card, each command a subprocess checked for its exit
    code and JSON keys: ``solvers``; ``solve`` on the pendulum and the cart-pole; ``export`` of
    phase 6's trained checkpoint and ``inspect``; ``serve`` answering 5 requests, a reset and a
    malformed line; ``calibrate`` on phase 7's probabilistic handler. ``learn`` needs gymnasium
    and runs where it is installed."""
    import importlib.util

    res = {}
    t0 = time.perf_counter()
    rc, _, err = cli(["solvers"])
    cli_gate("solvers", rc, [{}], err)
    for env in ("pendulum", "cartpole"):
        rc, lines, err = cli(["solve", "--env", env, "--steps", "20", "--population", "128",
                              "--planning-horizon", "15"])
        cli_gate(f"solve {env}", rc, lines, err,
                 ("env", "solver", "episode_rewards", "act_latency"))
        res[f"solve {env}"] = {"episode_rewards": lines[-1]["episode_rewards"],
                               "act_p50_ms": 1e3 * lines[-1]["act_latency"]["p50_s"]}
    ckpt, artifact = f"{workdir}/trained", f"{workdir}/trained.bbmpc"
    trained.save(ckpt)
    rc, lines, err = cli(["export", "--env", "pendulum", "--checkpoint-dir", ckpt, "-o",
                          artifact, "--population", "256", "--planning-horizon", "15",
                          "--iterations", "3"])
    cli_gate("export", rc, lines, err, ("artifact", "solver_name", "dim_s", "dim_u",
                                        "rng_impl", "platforms", "nr_devices"))
    if lines[-1]["platforms"] != ["cuda"] or lines[-1]["rng_impl"] != "philox4x32-10":
        raise AssertionError(f"cli export: {lines[-1]['platforms']}, {lines[-1]['rng_impl']}")
    rc, lines, err = cli(["inspect", artifact])
    cli_gate("inspect", rc, lines, err, ("solver_name", "tensors", "program_bytes"))
    if "cuda/step.pt2" not in lines[-1]["program_bytes"]:
        raise AssertionError(f"cli inspect: {lines[-1]['program_bytes']}")
    requests = [json.dumps({"obs": [0.5, 0.1, 0.0], "t": t, "explore": t == 2})
                for t in range(5)]
    requests[3:3] = [json.dumps({"cmd": "reset"}), "not json"]
    rc, lines, err = cli(["serve", artifact], "\n".join(requests + ['{"cmd": "close"}']) + "\n")
    cli_gate("serve", rc, lines, err)
    kinds = ["ready" if "ready" in ln else "action" if "action" in ln else "ok" if "ok" in ln
             else "error" for ln in lines]
    if kinds != ["ready", "action", "action", "action", "ok", "error", "action", "action"]:
        raise AssertionError(f"cli serve: answered {kinds}")
    for ln in lines:
        if "action" in ln and not (len(ln["action"]) == 1 and -2.0 <= ln["action"][0] <= 2.0):
            raise AssertionError(f"cli serve: action {ln['action']}")
    prob = f"{workdir}/probabilistic"
    probabilistic.save(prob)
    rc, lines, err = cli(["calibrate", prob])
    cli_gate("calibrate", rc, lines, err, ("variance_ratio", "coverage_1sigma",
                                           "coverage_2sigma", "per_dim_variance_ratio",
                                           "verdict"))
    res["calibrate"] = {k: lines[-1][k] for k in ("variance_ratio", "verdict")}
    if importlib.util.find_spec("gymnasium") is None:
        res["learn"] = "skipped: gymnasium is not installed here (learn runs on the CPU tests)"
    else:
        rc, lines, err = cli(["learn", "--env", "Pendulum-v1", "--steps", "10",
                              "--initial-rollouts", "1", "--refinements", "1", "--epochs", "1",
                              "--hidden", "16", "--population", "128", "--planning-horizon",
                              "5", "--iterations", "1"])
        cli_gate("learn", rc, lines, err, ("env", "replay_size", "done"))
        res["learn"] = "ran"
    res["cli_s"] = time.perf_counter() - t0
    print(json.dumps({"cli": res, "card": nvidia_smi()}), flush=True)
    return res


def phase9(device, workdir: str, trained, probabilistic) -> dict:
    """Phase 9, Parts A-D; ``trained`` and ``probabilistic`` are the handlers Part D saves
    and runs the command line on. Part D's subprocesses run while Part C exports and serves
    (both mostly host work, each minutes long), so Part C's numbers are taken beside them."""
    import concurrent.futures

    def timed_cli():
        with phase_timer("9D"):
            return cli_on_card(device, workdir, trained, probabilistic)

    with phase_timer("9A"):
        res = {"auto": auto_backend(device)}
    with phase_timer("9B"):
        res["episodes"] = device_episodes(device)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(timed_cli)
        with phase_timer("9C"):
            res["serving"] = serving_on_cuda(device, workdir)
        res["cli"] = cli.result()
    return res


# Phase 10: the parallel layer at the flagship (CEM H=50, population 1000, 5 iterations, 50
# elites, E=5 x 3x500 tanh, S=17, U=6, f32, seeded weights). Part A in a 1-rank NCCL world on
# this card; Part B in two ranks sharing the card over gloo (NCCL refuses two ranks on one
# card); Part C at BASELINE config #5's scale (benchmarks/scaling.py: population 100 000, elites
# population // 20); Part D the sharded artifact.
SHARDED_DRIVES = {
    "CEM": ("CEM", dict(num_elite=50, max_iterations=ITERS), BACKEND_KERNELS["fused"]),
    "iCEM decay": ("CEM", dict(num_elite=50, max_iterations=ITERS,
                               colored_noise_beta=COLORED_BETA, population_decay=0.8),
                   BACKEND_KERNELS["fused"]),
    "PI2": ("PI2", dict(max_iterations=ITERS), BACKEND_KERNELS["fused"]),
    "MPPI": ("MPPI", dict(max_iterations=ITERS), BACKEND_KERNELS["fused"]),
    "RandomSearch": ("RandomSearch", dict(), {"fused_rollout": 1, "draw_rows": 1}),
    "sep-CMA-ES": ("CMA-ES", dict(num_elite=50, max_iterations=ITERS, diagonal=True),
                   BACKEND_KERNELS["fused"]),
    "eager CEM": ("CEM", dict(num_elite=50, max_iterations=ITERS), {}),
}
CAPACITY = dict(population=100_000, num_elite=5_000, max_iterations=ITERS, diagonal=True)
# Part D's exported policy: the flagship model under a shorter eager CEM (the export traces
# every rollout step of every iteration).
ARTIFACT = dict(planning_horizon=10, population=200, num_elite=20, max_iterations=2)
PART_B_RANKS = 2
# The 2-rank card result against the same 2-rank run on CPU tensors (the plain versions),
# relative to max(1, max |cpu|).
CARD_VS_CPU_TOLERANCE = 1e-4


def sharded_policy(device, handler, label: str, mesh, **changes):
    """The drive ``label`` of SHARDED_DRIVES at the flagship over ``mesh`` (None: unsharded)."""
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    solver_name, kwargs, _ = SHARDED_DRIVES[label]
    kwargs = {"planning_horizon": HORIZON, "population": ROWS, **kwargs, **changes}
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=6), reward_fn, handler, solver_name=solver_name,
                     rollout_backend="eager" if label.startswith("eager") else "fused",
                     mesh=mesh, seed=0, device=device, **kwargs)


def sharded_acts(policy, label: str, steps: int = STEPS) -> dict:
    """A warm-up ``act()``, then ``steps`` closed-loop ones: all their outputs (for the bits),
    their ms, each kernel's launches over exactly those steps (gated against the drive's
    counts) and the plain RNG's calls on CUDA tensors (none)."""
    import numpy as np

    obs = np.zeros(17, np.float32)
    policy.act(obs)
    counters = zero_launches()
    outs, times = [], []
    with plain_rng_on_cuda() as plain_calls:
        for t in range(steps):
            t0 = time.perf_counter()
            out = policy.act(obs, t)
            times.append((time.perf_counter() - t0) * 1e3)
            if not (np.all(np.isfinite(out[0])) and np.all(np.abs(out[0]) <= 1.0)):
                raise AssertionError(f"{label}: action out of bounds or not finite: {out[0]}")
            outs.append(np.concatenate([np.ravel(x) for x in out]))
            obs = out[1]
    launches = read_launches(counters)
    expected = {name: steps * SHARDED_DRIVES[label.split(": ")[-1]][2].get(name, 0)
                for name in launches}
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the plain RNG ran on CUDA tensors: {plain_calls}")
    return {"outs": np.stack(outs), "act_ms": times, "act_ms_median": float(np.median(times)),
            "launches": launches}


def capacity_act(device, handler, mesh) -> dict:
    """Part C: one warm sep-CMA-ES ``act()`` at population 100 000 over ``mesh``: its seconds,
    the peak memory above what the process held before it, an action finite and in bounds."""
    import numpy as np
    import torch

    policy = sharded_policy(device, handler, "sep-CMA-ES", mesh, **CAPACITY)
    obs = np.zeros(17, np.float32)
    policy.act(obs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    action, _, _ = policy.act(obs)
    seconds = time.perf_counter() - t0
    if not (np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)):
        raise AssertionError(f"sep-CMA-ES at {CAPACITY['population']}, D={mesh.size}: {action}")
    return {"ranks": mesh.size, "candidates_per_rank": CAPACITY["population"] // mesh.size,
            "act_s": seconds, "peak_bytes": torch.cuda.max_memory_allocated() - base}


def pair_card_vs_cpu(device, handler, mesh) -> dict:
    """Part B: this rank's K4 rewards and K6 moments at its seed against their plain versions
    (phase 3's tolerances), and the sharded pair's result on the card (the gathered rewards,
    the reduced moments) against the same ranks' run on CPU tensors (the plain versions),
    CARD_VS_CPU_TOLERANCE. Rank 1's seed wraps in int32."""
    import numpy as np
    import torch

    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import fused_sharded as fs

    config, p_loc = handler.config, ROWS // mesh.size
    g = np.random.default_rng(6)
    hu = HORIZON * config.dim_u
    host = [g.normal(0, 1, (1, config.dim_s)), g.uniform(-0.3, 0.3, (1, hu)),
            g.uniform(0.2, 0.5, (1, hu))]
    seed = 1234567891
    mask = None
    got = []  # the card's run, then the CPU's
    for where in (device, torch.device("cpu")):
        dp = handler.dynamics_params.to(where)
        s0, mean, std = (torch.as_tensor(v, dtype=torch.float32, device=where) for v in host)
        rollout, moments = fs._sharded_pair(fc.make_fused_cem_kernels(
            config, reward_fn, horizon=HORIZON, agents=1, population=p_loc), mesh)
        rewards = rollout(dp, s0, mean, std, seed)
        if mask is None:  # the card's 50 elites: both runs reduce the same rows
            mask = np.zeros((ROWS, 1), np.float32)
            mask[np.argsort(-rewards[:, 0].cpu().numpy(), kind="stable")[:50]] = 1.0
        weights = torch.as_tensor(mask, device=where)
        rank_seed = fs.device_seed(torch.tensor([seed], dtype=torch.int32, device=where),
                                   mesh.rank)
        block = weights[mesh.rank * p_loc:(mesh.rank + 1) * p_loc].reshape(-1).contiguous()
        got.append([x.cpu().numpy() for x in (
            rollout.local(dp, s0, mean, std, rank_seed),
            *fc.elite_moments(std.reshape(1, -1), block, rank_seed, mean.reshape(1, -1)),
            rewards, *moments(mean, std, seed, weights))])

    def rel(a, b):
        return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))

    card, cpu = got
    errs = {"local K4 rewards": (rel(card[0], cpu[0]), TOLERANCE["float32"]),
            "local K6 moments": (max(rel(card[1], cpu[1]), rel(card[2], cpu[2])),
                                 MOMENT_TOLERANCE),
            "gathered rewards": (rel(card[3], cpu[3]), CARD_VS_CPU_TOLERANCE),
            "reduced moments": (max(rel(card[4], cpu[4]), rel(card[5], cpu[5])),
                                CARD_VS_CPU_TOLERANCE)}
    for what, (err, tol) in errs.items():
        if err > tol:
            raise AssertionError(f"rank {mesh.rank}: card vs CPU, {what}: {err} > {tol}")
    return {what: err for what, (err, _) in errs.items()}


def sharded_eager_peak(device, handler, mesh) -> dict:
    """Part B: this rank's peak memory in a one-iteration sharded eager CEM ``act()`` (the
    peak is one iteration's) at EAGER_PEAK_POPULATIONS, per byte of the whole candidate
    tensor: every rank draws and holds all of it and rolls out its block. The growth between
    the two populations, as phase 9 measures the unsharded eager path."""
    import numpy as np

    obs = np.zeros(17, np.float32)
    peaks = {}
    for population in EAGER_PEAK_POPULATIONS:
        policy = sharded_policy(device, handler, "eager CEM", mesh, population=population,
                                max_iterations=1)
        policy.act(obs)  # warm-up
        peaks[population] = act_peak_bytes(policy, obs)
        del policy
    low, high = EAGER_PEAK_POPULATIONS
    per_row = (peaks[high] - peaks[low]) / (high - low)
    return {"peak_bytes": peaks, "peak_per_candidate_byte": per_row / (HORIZON * 6 * 4)}


def sharded_ts_inf(device, mesh) -> dict:
    """Part B: phase 7's ``ts_inf`` drive (20 400 rows a step, E=5) sharded over the ranks,
    each rank's block grouped by the members of its rows of the whole batch
    (``models/dynamics.py::RowBlock``), and unsharded on rank 0 alone while the other ranks
    wait: the ``act()`` ms of each. No kernel launches on this path."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    config = LearnedDynamicsConfig(**PETS_NET, **PETS_DRIVES["ts_inf"])
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(pets_params(config, device))
    obs = np.zeros((PETS_AGENTS, config.dim_s), np.float32)

    def timed(m, label):
        policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.dim_u), cheetah_reward, handler,
                           num_agents=PETS_AGENTS, rollout_backend="eager", mesh=m, seed=0,
                           device=device, **PETS_SOLVER)
        policy.act(obs)  # warm-up
        times, launches, plain_calls, out = timed_acts(policy, obs, STEPS, label)
        if any(launches.values()) or any(plain_calls.values()):
            raise AssertionError(f"{label}: kernels launched {launches}, plain RNG on CUDA "
                                 f"{plain_calls}")
        return times, out[0]

    res = {}
    if mesh.rank == 0:
        res["single_act_ms"], _ = timed(None, "ts_inf unsharded")
    torch.distributed.barrier()
    res["sharded_act_ms"], res["action"] = timed(mesh, f"rank {mesh.rank}: sharded ts_inf")
    return res


def artifact_round_trip(device, handler, mesh, workdir: str) -> dict:
    """Part D: an eager CEM policy sharded over ``mesh`` acts once and exports this rank's
    artifact; the ServingPolicy loaded from it goes on beside it bit for bit: a greedy, a
    noisy and a post-reset ``act()``."""
    import numpy as np

    from blackbox_mpc_torch.deploy import ServingPolicy, export_policy_artifact

    live = sharded_policy(device, handler, "eager CEM", mesh, **ARTIFACT)
    obs = np.zeros(17, np.float32)
    live.act(obs)
    path = f"{workdir}/artifact.rank{mesh.rank}.bbmpc"
    t0 = time.perf_counter()
    meta = export_policy_artifact(live, path)
    export_s = time.perf_counter() - t0
    served = ServingPolicy.load(path, device=device)
    outs = []
    for policy in (live, served):
        steps = [policy.act(obs, 1), policy.act(obs, 2, exploration_noise=True)]
        policy.reset()
        steps.append(policy.act(obs, 3))
        outs.append(np.concatenate([np.ravel(x) for step in steps for x in step]))
    if not np.array_equal(*outs):
        raise AssertionError(f"rank {mesh.rank}: the served artifact left its live policy")
    if (served.meta["format_version"], meta["nr_devices"], meta["mesh_axes"]) != (
            2, mesh.size, {"pop": mesh.size}):
        raise AssertionError(f"rank {mesh.rank}: artifact meta {served.meta}")
    return {"path": path, "export_s": export_s}


def part_b_rank(rank: int, workdir: str, device: str) -> None:
    """One rank of Part B, and of Parts C and D at two ranks: a gloo world of PART_B_RANKS
    ranks on ``device``, the one card; the results go to ``<workdir>/rank<rank>.pkl``."""
    import pickle

    import numpy as np
    import torch

    from blackbox_mpc_torch.parallel import initialize_multihost, make_pop_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    initialize_multihost(f"file://{workdir}/gloo-store", PART_B_RANKS, rank, device=device,
                         backend="gloo")
    mesh = make_pop_mesh(device=device)
    handler = flagship_handler(device)
    res = {"drives": {label: sharded_acts(sharded_policy(device, handler, label, mesh),
                                          f"rank {rank}: {label}")
                      for label in SHARDED_DRIVES}}
    trace = trace_act(sharded_policy(device, handler, "CEM", mesh), np.zeros(17, np.float32),
                      f"rank {rank}: sharded fused CEM over gloo",
                      per_act=BACKEND_KERNELS["fused"], every_try=True)
    res["waits"] = trace["stream_syncs"]
    res["traced_launches"] = {k: trace[k] for k in ("k4_kernels", "k6_kernels",
                                                    "lost_record_traces")}
    res["card_vs_cpu"] = pair_card_vs_cpu(device, handler, mesh)
    res["capacity"] = capacity_act(device, handler, mesh)
    res["eager_peak"] = sharded_eager_peak(device, handler, mesh)
    res["ts_inf"] = sharded_ts_inf(device, mesh)
    res["artifact"] = artifact_round_trip(device, handler, mesh, workdir)
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def phase10(device, trained, workdir: str, eager_per_byte: float) -> dict:
    """Phase 10, Parts A-D; ``trained`` is phase 6's handler, whose replay Part A trains on;
    ``eager_per_byte`` is phase 9's unsharded eager peak per candidate byte."""
    import copy
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from blackbox_mpc_torch import DynamicsHandler
    from blackbox_mpc_torch.deploy import ServingPolicy
    from blackbox_mpc_torch.learning.trainer import flat_params
    from blackbox_mpc_torch.parallel import initialize_multihost, make_pop_mesh

    smi = nvidia_smi()
    # Part A: a 1-rank NCCL world; every sharded drive against its unsharded twin, bit for bit.
    with phase_timer("10A"):  # Part C at D=1 included
        initialize_multihost(f"file://{workdir}/nccl-store", 1, 0, device=device)
        mesh = make_pop_mesh(device=device)
        handler = flagship_handler(device)
        part_a = {}
        try:
            for label in SHARDED_DRIVES:
                single = sharded_acts(sharded_policy(device, handler, label, None), label)
                policy = sharded_policy(device, handler, label, mesh)
                sharded = sharded_acts(policy, f"1-rank NCCL: {label}")
                if not np.array_equal(single["outs"], sharded["outs"]):
                    raise AssertionError(f"1-rank NCCL: {label}: act() differs from the "
                                         "single-device one")
                part_a[label] = {"act_ms_median": sharded["act_ms_median"],
                                 "single_device_act_ms_median": single["act_ms_median"],
                                 "launches": sharded["launches"]}
                if label == "CEM":
                    trace = trace_act(policy, np.zeros(17, np.float32),
                                      "1-rank NCCL: sharded fused CEM",
                                      per_act=BACKEND_KERNELS["fused"])
                    gate_waits(trace, "1-rank NCCL: sharded fused CEM")
                    part_a[label]["k4_kernels_traced"] = trace["k4_kernels"]
                    part_a[label]["lost_record_traces"] = trace["lost_record_traces"]
                    part_a[label]["stream_syncs"] = trace["stream_syncs"]
                    part_a[label]["device_idle_share"] = trace["device_idle_share"]
            # A data-parallel train() on phase 6's replay, bit for bit with the unsharded one.
            runs = []
            for m in (None, mesh):
                h = DynamicsHandler(trained.config, seed=0, device=device, mesh=m)
                h._replay = copy.deepcopy(trained.replay)
                info = h.train(epochs=5, batch_size=128)
                runs.append((info["train_loss"], info["val_loss"],
                             [t.cpu() for t in flat_params(h.dynamics_params.params)]))
            (loss, val, params), (s_loss, s_val, s_params) = runs
            if (loss, val) != (s_loss, s_val) or not all(
                    torch.equal(a, b) for a, b in zip(params, s_params)):
                raise AssertionError("1-rank NCCL: data-parallel train() differs from the "
                                     "unsharded one")
            part_a["train"] = {"bitwise": True, "train_loss": s_loss, "val_loss": s_val}
            part_c = {"D=1": capacity_act(device, handler, mesh)}
        finally:
            torch.distributed.destroy_process_group()
        print(json.dumps({"phase10_part_a": part_a, "card": smi}), flush=True)

    # Part B, and Parts C and D at D=2: two ranks on this card over gloo.
    with phase_timer("10B"):  # Parts C and D at D=2 included
        mp.spawn(part_b_rank, args=(workdir, str(device)), nprocs=PART_B_RANKS, join=True)
        ranks = []
        for r in range(PART_B_RANKS):
            with open(f"{workdir}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for label in SHARDED_DRIVES:
            if not np.array_equal(ranks[0]["drives"][label]["outs"],
                                  ranks[1]["drives"][label]["outs"]):
                raise AssertionError(f"gloo 2 ranks: {label}: the ranks' act()s differ")
        part_b = {label: {"act_ms_median": [r["drives"][label]["act_ms_median"] for r in ranks],
                          "launches_per_rank": ranks[0]["drives"][label]["launches"]}
                  for label in SHARDED_DRIVES}
        part_b["waits_per_traced_act"] = [r["waits"] for r in ranks]  # gloo: through the host
        part_b["traced_launches"] = [r["traced_launches"] for r in ranks]
        for r, rank in enumerate(ranks):
            gate_traced_launches(rank["traced_launches"], f"gloo rank {r}: sharded fused CEM",
                                 BACKEND_KERNELS["fused"])
        part_b["card_vs_cpu"] = [r["card_vs_cpu"] for r in ranks]
        # The sharded eager path holds the whole candidate tensor on every rank: the capacity
        # threshold, set from the unsharded eager peak, holds for it only if no rank peaks higher.
        per_byte = [r["eager_peak"]["peak_per_candidate_byte"] for r in ranks]
        if max(per_byte) > eager_per_byte:
            raise AssertionError(f"gloo 2 ranks: sharded eager peaks at {per_byte} bytes per "
                                 f"candidate byte, above the unsharded {eager_per_byte}")
        total = torch.cuda.get_device_properties(0).total_memory
        part_b["eager_peak"] = {
            "peak_bytes": [r["eager_peak"]["peak_bytes"] for r in ranks],
            "peak_per_candidate_byte": per_byte, "unsharded_per_candidate_byte": eager_per_byte,
            "fused_min_bytes_measured": FUSED_MEMORY_SHARE * total / max(per_byte)}
        if not np.array_equal(ranks[0]["ts_inf"]["action"], ranks[1]["ts_inf"]["action"]):
            raise AssertionError("gloo 2 ranks: sharded ts_inf: the ranks' act()s differ")
        part_b["ts_inf"] = {
            "single_act_ms_median": float(np.median(ranks[0]["ts_inf"]["single_act_ms"])),
            "sharded_act_ms_median": [float(np.median(r["ts_inf"]["sharded_act_ms"]))
                                      for r in ranks]}
    part_b["seconds"] = PHASE_SECONDS["10B"]
    part_c["D=2"] = [r["capacity"] for r in ranks]
    print(json.dumps({"phase10_part_b": part_b, "card": smi}), flush=True)
    print(json.dumps({"phase10_part_c": part_c, "card": smi}), flush=True)
    # Part D: each rank's artifact served bit for bit (gated in the ranks); a world of
    # another size is refused.
    try:
        ServingPolicy.load(ranks[0]["artifact"]["path"], device=device)
    except ValueError as e:
        if "topology-pinned" not in str(e):
            raise
    else:
        raise AssertionError("a 2-rank artifact loaded outside a 2-rank world")
    part_d = {"export_s": [r["artifact"]["export_s"] for r in ranks],
              "served_bitwise": True, "wrong_world_refused": True}
    print(json.dumps({"phase10_part_d": part_d, "card": smi}), flush=True)
    return {"part_a": part_a, "part_b": part_b, "part_c": part_c, "part_d": part_d}


# Phase 11: the compiled serving cache and the tutorials on the card. Part A compiles the eager
# CEM step of phase 10 Part D's cut of the flagship (H=10, population 200, 2 iterations); the
# flagship's own step (H=50, 5 iterations) is compiled by ``--compiled-flagship``, which runs
# Part A alone at that shape. Part B runs four tutorials as a user would, without --cpu.
COMPILED_POLICY = dict(planning_horizon=10, population=200, max_iterations=2)
COMPILED_FLAGSHIP = dict(planning_horizon=HORIZON, max_iterations=ITERS)
# The compiled programs against the uncompiled ones on the same inputs (Inductor fuses and
# reorders reductions): relative to max(1, max |uncompiled|), on the action, the predictions,
# the expected reward and the plan.
COMPILED_TOL = 1e-4
COMPILED_STEPS = ((1, False), (2, True), (3, False))
# Each tutorial with tests/test_torch_tutorials.py's arguments and the line it must print.
TUTORIALS_ON_CARD = {
    "low_level_api/tutorial_one.py": ([], r"episode reward \S+, final cos"),
    "true_model_mpc/tutorial_one.py": (["--steps", "40"], r"CEM: episode reward \S+, act p50"),
    "deploy/tutorial_one.py": (["--steps", "30"],
                               r"compiled cache: .* used_compiled_cache=True"),
    "beyond_hbm/tutorial_one.py": (["--population", "256"], r"(?m)^OK$"),
}
# Runs a tutorial as __main__ in this process, then prints the kernels' launch counts.
_COUNTED = """
import json, runpy, sys
from chip_smoke import read_launches, zero_launches
counters = zero_launches()
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(json.dumps({"launches": read_launches(counters)}))
"""


def cxx_with_openmp() -> str:
    """The C++ compiler AOTInductor builds its packages with: ``$CXX`` if set, else the first
    of ``g++`` on the PATH, ``/usr/bin/g++`` and ``clang++`` that links an OpenMP program (the
    packages' code links libgomp). It becomes ``CXX`` of this process and its children."""
    import os
    import shutil
    import tempfile

    import torch._inductor.config as inductor_config

    candidates = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
                  shutil.which("clang++")]
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/t.cpp", "w") as f:
            f.write("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
        for cxx in candidates:
            if not cxx or not os.path.exists(cxx):
                continue
            out = subprocess.run([cxx, "-fopenmp", f"{tmp}/t.cpp", "-o", f"{tmp}/t"],
                                 capture_output=True, text=True)
            if out.returncode == 0:
                os.environ["CXX"] = cxx
                inductor_config.cpp.cxx = (None, cxx)
                return cxx
            print(f"compiled cache: {cxx} cannot link OpenMP: {out.stderr[-300:]}", flush=True)
    raise AssertionError(f"no C++ compiler links OpenMP among {candidates}")


def rel_err(got, want) -> float:
    import numpy as np

    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def compiled_cache_on_card(device, workdir: str, settings=COMPILED_POLICY) -> tuple:
    """Part A's gates: an eager CEM ``MPCPolicy`` at the flagship width (``settings`` cut its
    depth) exported after one ``act()``; ``precompile`` then ``save_compiled`` on one
    ServingPolicy, and ``load(compiled_cache=)`` into another with AOTInductor's compile
    refused. Gates: the cache is used; three ``act()``s (explore false, true, false), a reset
    and one more give the saving instance's bits, and agree with an uncompiled ServingPolicy at
    the same stream point within COMPILED_TOL; swapped params act as the uncompiled instance
    given them, within COMPILED_TOL; a cache with another device kind warns and is not used.
    Returns the measured seconds and sizes, and the three policies that
    :func:`compiled_cache_times` times."""
    import os
    import warnings
    import zipfile

    import numpy as np
    import torch

    from blackbox_mpc_torch.deploy import ServingPolicy, export_policy_artifact
    from blackbox_mpc_torch.models.dynamics import map_params

    smi = nvidia_smi()
    cxx = cxx_with_openmp()
    obs = np.zeros(17, np.float32)
    path, cache = f"{workdir}/compiled.bbmpc", f"{workdir}/compiled.cache"
    policy = flagship_policy(device, flagship_handler(device), "eager", **settings)
    policy.act(obs)  # mid-episode: the artifact resumes the state and the stream
    t0 = time.perf_counter()
    export_policy_artifact(policy, path)
    export_s = time.perf_counter() - t0
    saver, plain = ServingPolicy.load(path), ServingPolicy.load(path)
    t0 = time.perf_counter()
    saver.precompile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saver.save_compiled(cache)
    save_s = time.perf_counter() - t0
    compile_fn = torch._inductor.aoti_compile_and_package

    def refuse(*args, **kwargs):
        raise AssertionError("compiled cache: loading the cache compiled a program")

    torch._inductor.aoti_compile_and_package = refuse
    try:
        t0 = time.perf_counter()
        cached = ServingPolicy.load(path, compiled_cache=cache)
        load_s = time.perf_counter() - t0
    finally:
        torch._inductor.aoti_compile_and_package = compile_fn
    if not cached.used_compiled_cache:
        raise AssertionError("compiled cache: load(compiled_cache=) did not use the cache")

    def step(srv, t, explore):
        return srv.act(obs, t, exploration_noise=explore) + srv.plan()

    err = 0.0
    for i, (t, explore) in enumerate(COMPILED_STEPS + ((4, False),)):
        if i == len(COMPILED_STEPS):
            for srv in (saver, cached, plain):
                srv.reset()
        a, b, c = (step(srv, t, explore) for srv in (saver, cached, plain))
        if not all(same_bits(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"compiled cache: act(t={t}) differs from the saving "
                                 "instance's bits")
        err = max(err, max(rel_err(x, y) for x, y in zip(a, c)))
    if err > COMPILED_TOL:
        raise AssertionError(f"compiled cache: compiled and uncompiled differ by {err}")
    new = policy.dynamics_handler.dynamics_params
    new = new.replace(params=map_params(lambda v: v + 0.01, new.params))
    for srv in (cached, plain):
        srv.update_dynamics_params(new)
    swap_err = max(rel_err(x, y) for x, y in zip(step(cached, 5, False), step(plain, 5, False)))
    if swap_err > COMPILED_TOL:
        raise AssertionError(f"compiled cache: swapped params differ by {swap_err}")
    stale = f"{workdir}/stale.cache"
    with zipfile.ZipFile(cache) as src, zipfile.ZipFile(stale, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "fingerprint.json":
                data = json.dumps({**json.loads(data), "device_kind": "another card"})
            dst.writestr(name, data)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        refused = ServingPolicy.load(path, compiled_cache=stale)
    if refused.used_compiled_cache or not any(
            issubclass(w.category, RuntimeWarning)
            and str(w.message).startswith("ignoring compiled cache") for w in caught):
        raise AssertionError("compiled cache: a cache of another device kind was not refused")
    res = {"compiled_cache": "bit for bit with the saving instance", "settings": settings,
           "cxx": cxx, "export_s": export_s, "compile_s": compile_s, "save_s": save_s,
           "load_s": load_s, "cache_bytes": os.path.getsize(cache),
           "artifact_bytes": os.path.getsize(path),
           "compiled_vs_uncompiled_rel_err": err, "params_swap_rel_err": swap_err,
           "stale_cache_refused": True, "card": smi}
    return res, {"compiled ServingPolicy": cached, "uncompiled ServingPolicy": plain,
                 "MPCPolicy": policy}


def compiled_cache_times(res: dict, policies: dict) -> dict:
    """Part A's timings, with nothing else on the card: the ``act()`` ms of the compiled and
    the uncompiled ServingPolicy and of ``MPCPolicy.act`` on the same observation, and one
    traced compiled ``act()`` (waits, idle share). Prints Part A with the card's name and
    power limit."""
    import numpy as np

    obs = np.zeros(17, np.float32)
    times = {label: act_ms(policy, obs, 5) for label, policy in policies.items()}
    trace = trace_act(policies["compiled ServingPolicy"], obs, "compiled ServingPolicy")
    gate_waits(trace, "compiled ServingPolicy")
    res = {**res, "act_ms": {k: float(np.median(v)) for k, v in times.items()},
           "act_ms_all": times,
           "traced_act": {k: trace[k] for k in ("stream_syncs", "event_syncs",
                                                "device_idle_share", "device_ops",
                                                "act_window_us")}}
    print(json.dumps({"phase11_part_a": res}), flush=True)
    return res


@contextlib.contextmanager
def tutorials_running():
    """Part B: four tutorials of ``tutorials_torch/`` as subprocesses without ``--cpu``, all
    started together, each under a wrapper that prints the kernels' launch counts. Yields
    what :func:`finish_tutorials` takes; every process is stopped on the way out."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = {}
    try:
        for name, (extra, _) in TUTORIALS_ON_CARD.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", _COUNTED, f"{root}/tutorials_torch/{name}", *extra],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        yield time.perf_counter(), procs
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()


def finish_tutorials(started: tuple) -> dict:
    """Part B's gates: each tutorial exits 0 and prints its result line; ``beyond_hbm``
    launches K3, K4 and K6."""
    import re

    t0, procs = started
    res = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        pattern = TUTORIALS_ON_CARD[name][1]
        if proc.returncode != 0 or not re.search(pattern, out):
            raise AssertionError(f"tutorial {name}: exit code {proc.returncode}, output "
                                 f"{out[-1500:]}\n{err[-3000:]}")
        lines = [ln for ln in out.splitlines() if ln.strip()]
        res[name] = {"result": lines[-2] if len(lines) > 1 else "",
                     "launches": json.loads(lines[-1])["launches"]}
    fused = res["beyond_hbm/tutorial_one.py"]["launches"]
    if not all(fused[k] for k in ("fused_rollout", "elite_moments", "draw_rows")):
        raise AssertionError(f"tutorial beyond_hbm: K3, K4 and K6 did not all launch: {fused}")
    out = {"tutorials": res, "seconds": time.perf_counter() - t0, "card": nvidia_smi()}
    print(json.dumps({"phase11_part_b": out}), flush=True)
    return out


# Phase 12: the JAX package's checkpoints on the card, read by learning/orbax_read.py and
# written by learning/orbax_write.py with no JAX, Orbax, tensorstore or zstandard. Part A reads
# every committed Orbax tree and the JAX-written loop to the digests Orbax's own restore gave on
# the CPU; Part B plans on the committed trained weights and stats (phase 7's PETS drives and
# phase 8 A's Gradient+BC); Part C resumes the JAX-written loop with the port on "fused" and on
# "kernel"; Part D saves every tree of Part A again from the card; Part E holds the JAX
# package's surface on the card (below).
JAX_DIGESTS = "tests/torch_fixtures/jax_checkpoint_digests.json"
JAX_LOOP = "tests/torch_fixtures/jax_pendulum_loop"  # the digests' trees are named from the root
TRAINED_LEARNING_RATE = 3e-3  # the committed runs' (benchmarks/cheetah_mbrl.py)
# Part B's drives on the trained weights, by label: (checkpoint, config changes, the phase 7
# or 8 A drive whose seeded-weight median it is printed beside).
TRAINED_DRIVES = {
    "ts_inf, ckpt_tsinf_p20_lvb": ("ckpt_tsinf_p20_lvb", {}, "ts_inf"),
    "ts_inf, ckpt_tsinf_p20": ("ckpt_tsinf_p20", {}, "ts_inf"),
    "mm, ckpt_tsinf_p20_lvb": ("ckpt_tsinf_p20_lvb", {"propagation": "mm"}, "mm"),
    "mean, ckpt_gradient_bc_300": ("ckpt_gradient_bc_300", {}, "mean"),
}
# One-step predictions of a loaded handler, card against CPU, on this many replay rows.
PREDICT_ROWS = 1024
# Part C: the resumed refinement collects this many steps with two envs, planning with phase
# 6's CEM (H=50, population 1000, 50 elites, 5 iterations) through the fixture's (64, 64) model.
RESUME_STEPS = 20


def in_repo(path: str) -> str:
    """``path`` (relative to the repository's root) from wherever the script runs."""
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), path)


def gate_digests(got: dict, want: dict, label: str) -> None:
    bad = sorted(name for name in set(got) | set(want) if got.get(name) != want.get(name))
    if bad:
        raise AssertionError(f"{label}: leaves differ from the digests of Orbax's restore: "
                             f"{bad[:8]}")


def read_jax_trees(digests: dict) -> dict:
    """Part A: each tree of the digests read with ``restore_pytree``; every leaf's dtype,
    shape and SHA-256 must be the JSON's. Returns the read seconds per tree."""
    from blackbox_mpc_torch.learning.orbax_read import leaf_digests, restore_pytree

    seconds = {}
    for tree, want in digests.items():
        t0 = time.perf_counter()
        restored = restore_pytree(in_repo(tree))
        seconds[tree] = time.perf_counter() - t0
        gate_digests(leaf_digests(restored), want, f"Part A: {tree}")
    return seconds


def trained_drives(device, smi: str, seeded: dict) -> dict:
    """Part B: the committed checkpoints through ``DynamicsHandler.load(..., device)``; each
    one's one-step predictions on the card against the CPU's; phase 7's drives and phase 8
    A's Gradient+BC planning on the trained weights and stats (actions finite and in bounds,
    no kernel launched, at most MAX_SYNCS waits in a traced ``act()``), their ``act()``
    medians beside the seeded-weight ones (``seeded``); ``calibrate`` on
    ``ckpt_tsinf_p20_lvb``."""
    import dataclasses

    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.learning.orbax_read import restore_pytree
    from blackbox_mpc_torch.learning.proposer import ProposerConfig
    from blackbox_mpc_torch.models.convert import proposer_from_numpy

    handlers, res = {}, {"load_s": {}, "predict_rel_err": {}, "drives": {}}
    for name in sorted({ckpt for ckpt, _, _ in TRAINED_DRIVES.values()}):
        t0 = time.perf_counter()
        directory = in_repo(f"benchmarks/{name}/handler")
        handlers[name] = DynamicsHandler.load(directory, device=device,
                                              learning_rate=TRAINED_LEARNING_RATE)
        res["load_s"][name] = time.perf_counter() - t0
        on_cpu = DynamicsHandler.load(directory, device="cpu",
                                      learning_rate=TRAINED_LEARNING_RATE)
        s, a, _ = on_cpu.replay.arrays()
        s, a = torch.as_tensor(s[:PREDICT_ROWS]), torch.as_tensor(a[:PREDICT_ROWS])
        want = on_cpu.mean_dynamics_fn(on_cpu.dynamics_params, s, a)
        h = handlers[name]
        got = h.mean_dynamics_fn(h.dynamics_params, s.to(device), a.to(device)).cpu()
        err, scale = float((got - want).abs().max()), max(1.0, float(want.abs().max()))
        res["predict_rel_err"][name] = err / scale
        if not bool(torch.isfinite(got).all()) or err > TOLERANCE["float32"] * scale:
            raise AssertionError(f"{name}: one-step predictions card vs CPU {err} > "
                                 f"{TOLERANCE['float32']} * {scale}")
    space = BoxSpace.of(-1.0, 1.0, dim=PETS_NET["dim_u"])

    def drive(label, policy, obs, seeded_label, phase):
        policy.act(obs)  # warm-up
        times, launches, plain_calls, (_, nxt, _) = timed_acts(policy, obs, STEPS, label)
        if any(launches.values()) or any(plain_calls.values()):
            raise AssertionError(f"{label}: kernels launched {launches}; the path launches none")
        trace = trace_act(policy, nxt, label)
        gate_waits(trace, label)
        res["drives"][label] = {
            "act_ms": times, "act_ms_median": float(np.median(times)),
            f"seeded_weights_act_ms_median_phase{phase}": seeded[seeded_label],
            "stream_syncs": trace["stream_syncs"], "device_idle_share": trace["device_idle_share"]}

    for label, (name, changes, seeded_label) in TRAINED_DRIVES.items():
        handler = handlers[name]
        if changes:
            handler = DynamicsHandler(dataclasses.replace(handler.config, **changes), seed=0,
                                      device=device)
            handler.set_params(handlers[name].dynamics_params)
        obs = handlers[name].replay.arrays()[0][-PETS_AGENTS:]
        drive(label, MPCPolicy(space, cheetah_reward, handler, num_agents=PETS_AGENTS,
                               rollout_backend="eager", seed=0, device=device, **PETS_SOLVER),
              obs, seeded_label, 7)
    # Gradient+BC: the committed run's model and its behaviour-cloned proposer.
    handler = handlers["ckpt_gradient_bc_300"]
    proposer = proposer_from_numpy(
        restore_pytree(in_repo("benchmarks/ckpt_gradient_bc_300/proposer")),
        ProposerConfig(dim_s=handler.config.dim_s, dim_u=handler.config.dim_u,
                       hidden=BC_HIDDEN), Bounds.from_space(space), device=device)
    label = "Gradient + proposer, ckpt_gradient_bc_300"
    drive(label, MPCPolicy(space, cheetah_reward, handler, solver_name="Gradient",
                           num_agents=GBC_AGENTS, planning_horizon=GBC_HORIZON,
                           rollout_backend="eager", seed=0, device=device, proposer=proposer,
                           **FIRST_ORDER["Gradient"]),
          handler.replay.arrays()[0][-GBC_AGENTS:], "Gradient + proposer", 8)
    rc, lines, stderr = cli(["calibrate", in_repo("benchmarks/ckpt_tsinf_p20_lvb")])
    cli_gate("calibrate (JAX checkpoint)", rc, lines, stderr,
             keys=("variance_ratio", "coverage_1sigma", "val_points", "verdict"))
    res["calibrate"] = {k: lines[-1][k] for k in ("variance_ratio", "val_points", "verdict")}
    res["card"] = smi
    return res


def resume_jax_loop(device, backend: str, workdir: str, want: dict) -> dict:
    """Part C on one backend: a copy of the JAX-written loop, whose handler loads to the
    digests of its Orbax tree (``want``), resumed by the port for one refinement with its
    proposer; K2, or K4 and K6, launched ``RESUME_STEPS`` x their per-``act()`` counts and
    nothing else; the checkpoint it writes is the JAX package's trees of the live handler and
    proposer, with no file of the JAX-written ones left, and loads back bit for bit."""
    import shutil

    from blackbox_mpc_torch import DynamicsHandler
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.learning.orbax_read import leaf_digests
    from blackbox_mpc_torch.models.analytic import pendulum_reward
    from blackbox_mpc_torch.models.convert import handler_to_numpy
    from blackbox_mpc_torch.workflows import learn_dynamics_iteratively_w_mpc

    label = f"resumed JAX loop, {backend}"
    work = f"{workdir}/jax_loop_{backend}"
    shutil.copytree(in_repo(JAX_LOOP), work)
    before = DynamicsHandler.load(f"{work}/handler", device=device)
    gate_digests(leaf_digests(handler_to_numpy(before)[1]), want,
                 f"{label}: the handler as loaded")
    env = NativePendulumVecEnv(num_envs=2, seed=1, max_episode_steps=RESUME_STEPS)
    counters = zero_launches()
    t0 = time.perf_counter()
    with plain_rng_on_cuda() as plain_calls:
        handler, policy = learn_dynamics_iteratively_w_mpc(
            env, pendulum_reward, solver_name="CEM", planning_horizon=HORIZON,
            number_of_refinement_steps=2, rollout_horizon=RESUME_STEPS,
            epochs=MBRL["epochs"], batch_size=MBRL["batch_size"], population=ROWS,
            num_elite=50, max_iterations=ITERS, rollout_backend=backend, seed=0,
            checkpoint_dir=work, resume=True, behavior_cloning=True, bc_epochs=5,
            device=device)
    loop_s = time.perf_counter() - t0
    launches = read_launches(counters)
    expected = {name: RESUME_STEPS * BACKEND_KERNELS[backend].get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}; "
                             f"plain RNG on CUDA {plain_calls}")
    with open(f"{work}/loop_state.json") as f:
        completed = json.load(f)["completed_refinements"]
    grown = len(handler.replay) - len(before.replay)
    if (completed, grown) != (2, RESUME_STEPS * 2):
        raise AssertionError(f"{label}: resumed to {completed} refinements, {grown} transitions")
    # The JAX package's trees replaced: no stale OCDBT file or payload beside them.
    written_in_jax_format(work, handler, policy.proposer, label)
    checkpoint_matches(handler, DynamicsHandler.load(f"{work}/handler", device=device))
    return {"launches": launches, "loop_s": loop_s, "train_calls": handler._train_calls,
            "replay": len(handler.replay)}


def resave_jax_trees(device, workdir: str, digests: dict) -> dict:
    """Part D: each tree of the digests loaded onto the card (a handler through
    ``DynamicsHandler.load``, a proposer through ``proposer_from_numpy``) and saved again by the
    port under ``workdir``; ``restore_pytree`` of what it wrote must give the JSON's digests,
    and no OCDBT file may be written. Returns the save seconds per tree."""
    import os

    from blackbox_mpc_torch import DynamicsHandler
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.learning.orbax_read import leaf_digests, restore_pytree
    from blackbox_mpc_torch.learning.orbax_write import save_pytree
    from blackbox_mpc_torch.learning.proposer import ProposerConfig
    from blackbox_mpc_torch.models.convert import proposer_from_numpy, proposer_to_numpy

    seconds = {}
    for tree, want in digests.items():
        out = f"{workdir}/resaved/{tree}"
        if tree.endswith("handler/checkpoint"):
            handler = DynamicsHandler.load(in_repo(os.path.dirname(tree)), device=device)
            t0 = time.perf_counter()
            handler.save(os.path.dirname(out))
        else:
            state = restore_pytree(in_repo(tree))
            widths = [layer["w"].shape for layer in state["params"]]
            config = ProposerConfig(dim_s=widths[0][0], dim_u=widths[-1][1],
                                    hidden=tuple(w[1] for w in widths[:-1]))
            proposer = proposer_from_numpy(state, config,
                                           Bounds.of(-1.0, 1.0, dim=config.dim_u), device=device)
            t0 = time.perf_counter()
            save_pytree(out, proposer_to_numpy(proposer))
        seconds[tree] = time.perf_counter() - t0
        gate_digests(leaf_digests(restore_pytree(out)), want, f"Part D: {tree}, saved again")
        stray = stray_files(os.path.dirname(out))
        if stray:
            raise AssertionError(f"Part D: {tree} saved again holds {stray}")
    return seconds


def phase12(device, workdir: str, seeded: dict) -> dict:
    """Phase 12, Parts A-E (see the module's doc); ``seeded`` holds phase 7's and 8 A's
    ``act()`` medians on seeded weights, by drive."""
    smi = nvidia_smi()
    with open(in_repo(JAX_DIGESTS)) as f:
        digests = json.load(f)
    t0 = time.perf_counter()
    with phase_timer("12A"):
        part_a = {"read_s": read_jax_trees(digests), "leaves": sum(map(len, digests.values())),
                  "card": smi}
    print(json.dumps({"phase12_part_a": part_a}), flush=True)
    with phase_timer("12B"):
        part_b = trained_drives(device, smi, seeded)
    print(json.dumps({"phase12_part_b": part_b}), flush=True)
    want = digests[f"{JAX_LOOP}/handler/checkpoint"]
    with phase_timer("12C"):
        part_c = {backend: resume_jax_loop(device, backend, workdir, want)
                  for backend in ("fused", "kernel")}
    print(json.dumps({"phase12_part_c": part_c, "card": smi}), flush=True)
    with phase_timer("12D"):
        part_d = {"save_s": resave_jax_trees(device, workdir, digests),
                  "read_s_part_a": part_a["read_s"], "card": smi}
    print(json.dumps({"phase12_part_d": part_d}), flush=True)
    with phase_timer("12E"):
        part_e = jax_surface_on_card(device, workdir)
    print(json.dumps({"phase12_s": time.perf_counter() - t0}), flush=True)
    return {"part_a": part_a, "part_b": part_b, "part_c": part_c, "part_d": part_d,
            "part_e": part_e}


# Phase 12 Part E: the JAX package's surface on the card. The flagship's bounds are replaced
# (``Bounds.replace``) by a box of half the width, off centre, after the old box's tensors were
# made on the card; every solve on the replaced Bounds must be a fresh Bounds' solve, bit for bit.
HALF_BOX = (-0.25, 0.75)
# The solves on the replaced Bounds, by label: the kernels one solve launches, and how often.
SURFACE_SOLVES = {"fused CEM": BACKEND_KERNELS["fused"],
                  "fused RandomSearch": FUSED_FAMILY["fused RandomSearch"][2],
                  "kernel CEM": BACKEND_KERNELS["kernel"]}
EXPORT_CPU_TOLERANCE = 1e-4  # export_dynamics(platforms=("cpu",)) against the card
# adam_polish with a torch.optim.Adam callable against the float path (optax's Adam written
# out) on the same plans: the distance between the two results, relative to how far the
# float path moved the plans.
POLISH_AGREEMENT = 0.01


class SolverAct:
    """``act()`` of one solver on the card as ``MPCPolicy.act`` makes it (the observation in,
    one solve, the action and the plan out in one copy), for ``trace_act``."""

    def __init__(self, solver, device, seed: int = 0):
        import torch

        self.solver, self.device = solver, device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.state = solver.init(self.generator)

    def act(self, obs, t: int = 0, exploration_noise: bool = False):
        import numpy as np
        import torch

        del exploration_noise
        with torch.no_grad():
            o = torch.as_tensor(np.asarray(obs, np.float32).reshape(1, -1), device=self.device)
            action, self.state, aux = self.solver.solve(self.state, o, t, self.generator)
            flat = torch.cat([action.reshape(-1), aux.plan.reshape(-1)]).cpu().numpy()
        return flat[:action.numel()].reshape(action.shape), flat[action.numel():]


def surface_solver(label: str, bounds, handler, device):
    """The solve of SURFACE_SOLVES ``label`` at the flagship (H=50, population 1000, 5
    iterations, 50 elites) on ``bounds``."""
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops.rollout_kernel import make_rollout_kernel_evaluator
    from blackbox_mpc_torch.solvers import make_solver
    from blackbox_mpc_torch.solvers.cem import CEMConfig
    from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig

    cem = dict(planning_horizon=HORIZON, population=ROWS, num_elite=50, max_iterations=ITERS)
    params = lambda: handler.dynamics_params  # noqa: E731
    if label == "fused CEM":
        return fc.make_fused_cem(CEMConfig(**cem), bounds, handler.config, params, reward_fn)
    if label == "fused RandomSearch":
        return fc.make_fused_random_search(
            RandomSearchConfig(planning_horizon=HORIZON, population=ROWS), bounds,
            handler.config, params, reward_fn)
    evaluate = make_rollout_kernel_evaluator(handler.config, reward_fn, device=device)
    return make_solver("CEM", bounds, lambda obs, a: evaluate(params(), obs, a), **cem)


def replaced_bounds_solves(device, handler, smi: str) -> dict:
    """Each solve of SURFACE_SOLVES on ``Bounds.replace``d bounds whose old box's tensors and
    constants were made on the card, and on a fresh ``Bounds`` of the new box: the same bits,
    every action and plan inside the new box, the launches exact; one traced fused CEM
    ``act()`` on the replaced bounds waits exactly twice."""
    import numpy as np

    from blackbox_mpc_torch.core.types import Bounds

    obs = np.zeros(FLAGSHIP["dim_s"], np.float32)
    lower, upper = (np.full(FLAGSHIP["dim_u"], x, np.float32) for x in HALF_BOX)
    res = {}
    for label, per_act in SURFACE_SOLVES.items():
        old = Bounds.of(-1.0, 1.0, dim=FLAGSHIP["dim_u"])
        old.on(device)
        for name in ("midpoint", "default_variance"):
            old.constant(name, device)
        SolverAct(surface_solver(label, old, handler, device), device).act(obs)  # old box
        runs = {}
        for which, bounds in (("replaced", old.replace(lower=lower, upper=upper)),
                              ("fresh", Bounds(lower, upper))):
            actor = SolverAct(surface_solver(label, bounds, handler, device), device, seed=1)
            counters = zero_launches()
            t0 = time.perf_counter()
            action, plan = actor.act(obs)
            ms = (time.perf_counter() - t0) * 1e3
            runs[which] = {"action": action, "plan": plan, "ms": ms,
                           "launches": read_launches(counters), "actor": actor}
        got, want = runs["replaced"], runs["fresh"]
        expected = {name: per_act.get(name, 0) for name in got["launches"]}
        if got["launches"] != expected:
            raise AssertionError(f"replaced Bounds, {label}: launches {got['launches']}, "
                                 f"expected {expected}")
        if not (same_bits(got["action"], want["action"]) and same_bits(got["plan"], want["plan"])):
            raise AssertionError(f"replaced Bounds, {label}: the solve differs from a fresh "
                                 "Bounds' of the same box")
        inside = all(np.all(x >= HALF_BOX[0]) and np.all(x <= HALF_BOX[1])
                     for x in (got["action"], got["plan"]))
        if not inside:
            raise AssertionError(f"replaced Bounds, {label}: an action outside {HALF_BOX}")
        res[label] = {"launches": got["launches"], "bitwise_with_fresh_bounds": True,
                      "ms": got["ms"], "action": [float(a) for a in got["action"].ravel()]}
        if label == "fused CEM":
            trace = trace_act(got["actor"], obs, "replaced Bounds, fused CEM", per_act=per_act)
            if trace["stream_syncs"] != MAX_SYNCS:
                raise AssertionError(f"replaced Bounds, fused CEM: {trace['stream_syncs']} "
                                     f"cudaStreamSynchronize calls in one act(), expected "
                                     f"{MAX_SYNCS}")
            res[label].update(stream_syncs=trace["stream_syncs"],
                              device_idle_share=trace["device_idle_share"])
    print(json.dumps({"phase12_part_e_bounds": res, "card": smi}), flush=True)
    return res


def export_dynamics_for_cpu(device, handler, workdir: str, smi: str) -> dict:
    """``export_dynamics(handler on the card, platforms=("cpu",))``: the program loads and
    predicts on the CPU as the handler does on the card, within EXPORT_CPU_TOLERANCE of
    max(1, max|card|), and the handler stays on the card."""
    import torch

    from blackbox_mpc_torch.deploy import export_dynamics

    path = f"{workdir}/dynamics_cpu.pt2"
    home = (handler.device, handler.dynamics_params.stats.std_states.device)
    t0 = time.perf_counter()
    export_dynamics(handler, path, platforms=("cpu",))
    export_s = time.perf_counter() - t0
    program = torch.export.load(path).module()
    g = torch.Generator(device=device).manual_seed(11)
    s = torch.randn((PREDICT_ROWS, FLAGSHIP["dim_s"]), generator=g, device=device)
    a = torch.rand((PREDICT_ROWS, FLAGSHIP["dim_u"]), generator=g, device=device) * 2 - 1
    with torch.no_grad():
        want = handler.mean_dynamics_fn(handler.dynamics_params, s, a).cpu()
        got = program(s.cpu(), a.cpu())
    err = float((got - want).abs().max() / want.abs().max().clamp(min=1))
    if not err <= EXPORT_CPU_TOLERANCE:
        raise AssertionError(f"export_dynamics(platforms=('cpu',)) differs from the card by "
                             f"{err} of max(1, max|card|)")
    if (handler.device, handler.dynamics_params.stats.std_states.device) != home:
        raise AssertionError("export_dynamics moved the handler off the card")
    res = {"rows": PREDICT_ROWS, "cpu_vs_card": err, "export_s": export_s, "card": smi}
    print(json.dumps({"phase12_part_e_export_dynamics": res}), flush=True)
    return res


def adam_polish_optimizers(device, smi: str) -> dict:
    """Phase 8 A's Gradient solver with ``adam_polish`` given a float (optax's Adam written
    out) and a callable making ``torch.optim.Adam`` at the same rate, betas and eps, on the
    same inputs: the ones the first polish of a float-path ``act()`` received. The callable's
    plans must lie within POLISH_AGREEMENT of the float path's, relative to how far the float
    path moved them (a callable whose optimizer never stepped would be 1.0 away). Both polish
    calls and both paths' ``act()`` are timed; the callable's ``act()`` launches no kernel and
    waits at most twice when profiled."""
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.solvers import base

    config = LearnedDynamicsConfig(**GBC_NET)
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(pets_params(config, device))
    float_polish = base.adam_polish
    inputs = []

    def torch_adam(lr):
        return lambda ps: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def recorded(evaluate, bounds, lr, plans, iterations):
        if not inputs:
            inputs.append((evaluate, bounds, lr, plans.clone(), iterations))
        return float_polish(evaluate, bounds, lr, plans, iterations)

    def with_torch_adam(evaluate, bounds, lr, plans, iterations):
        return float_polish(evaluate, bounds, torch_adam(lr), plans, iterations)

    obs = np.zeros((GBC_AGENTS, config.dim_s), np.float32)
    res, policies = {}, {}
    try:
        for label, polish in (("float", recorded), ("torch.optim.Adam", with_torch_adam)):
            base.adam_polish = polish
            policies[label] = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.dim_u), cheetah_reward,
                                        handler, solver_name="Gradient", num_agents=GBC_AGENTS,
                                        planning_horizon=GBC_HORIZON, seed=0, device=device,
                                        **FIRST_ORDER["Gradient"])
            times, launches, _, (_, nxt, _) = timed_acts(policies[label], obs, 2,
                                                         f"Gradient, adam_polish {label}")
            if any(launches.values()):
                raise AssertionError(f"adam_polish {label}: kernels launched {launches}")
            res[label] = {"act_ms": times}  # the first includes the warm-up
        label = "Gradient, adam_polish torch.optim.Adam"
        _, syncs, _ = count_waits(lambda: policies["torch.optim.Adam"].act(nxt))
    finally:
        base.adam_polish = float_polish
    gate_waits({"stream_syncs": syncs}, label)
    res["torch.optim.Adam"]["stream_syncs"] = syncs
    evaluate, bounds, lr, plans, iterations = inputs[0]
    outs, polish_ms = {}, {}
    for name, optimizer in (("float", lr), ("torch.optim.Adam", torch_adam(lr))):
        polish_ms[name] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = float_polish(evaluate, bounds, optimizer, plans, iterations)
            torch.cuda.synchronize()
            polish_ms[name].append((time.perf_counter() - t0) * 1e3)
    lower, upper = bounds.on(device)
    moved = float(torch.linalg.vector_norm(outs["float"] - bounds.clip(plans)))
    off = float(torch.linalg.vector_norm(outs["torch.optim.Adam"] - outs["float"]))
    inside = bool(((outs["torch.optim.Adam"] >= lower) & (outs["torch.optim.Adam"] <= upper))
                  .all())
    if not (moved > 0 and off <= POLISH_AGREEMENT * moved and inside
            and bool(torch.isfinite(outs["torch.optim.Adam"]).all())):
        raise AssertionError(f"adam_polish(torch.optim.Adam callable): {off} from the float "
                             f"path, which moved the plans {moved} (at most "
                             f"{POLISH_AGREEMENT} of it), inside the bounds: {inside}")
    res["polish"] = {"plans": list(plans.shape), "iterations": iterations,
                     "float_path_moved": moved, "callable_off": off,
                     "relative": off / moved, "ms": polish_ms}
    print(json.dumps({"phase12_part_e_adam_polish": res, "card": smi}), flush=True)
    return res


def jax_backend_names(device, smi: str) -> dict:
    """``rollout_backend="pallas"`` builds the ``"kernel"`` policy (K2 five times an
    ``act()``) and ``"xla"`` the ``"eager"`` one (no kernel), each with the bits of the
    policy built by the port's name."""
    import numpy as np

    handler = flagship_handler(device)
    obs = np.zeros(FLAGSHIP["dim_s"], np.float32)
    res = {}
    for jax_name, port_name in (("pallas", "kernel"), ("xla", "eager")):
        outs = []
        for name in (jax_name, port_name):
            policy = flagship_policy(device, handler, name)
            if policy.rollout_backend != port_name:
                raise AssertionError(f"rollout_backend={name!r} built "
                                     f"{policy.rollout_backend!r}, not {port_name!r}")
            policy.act(obs)  # warm-up
            counters = zero_launches()
            outs.append(policy.act(obs))
            launches = read_launches(counters)
            expected = {k: BACKEND_KERNELS[port_name].get(k, 0) for k in launches}
            if launches != expected:
                raise AssertionError(f"rollout_backend={name!r}: launches {launches}, "
                                     f"expected {expected}")
        if not all(same_bits(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"rollout_backend={jax_name!r} acts otherwise than "
                                 f"{port_name!r}")
        res[jax_name] = {"builds": port_name, "launches": launches, "bitwise": True}
    print(json.dumps({"phase12_part_e_backend_names": res, "card": smi}), flush=True)
    return res


def jax_surface_on_card(device, workdir: str) -> dict:
    """Phase 12 Part E (see the module's doc)."""
    smi = nvidia_smi()
    handler = flagship_handler(device)
    parts = {"bounds": lambda: replaced_bounds_solves(device, handler, smi),
             "export_dynamics": lambda: export_dynamics_for_cpu(device, handler, workdir, smi),
             "adam_polish": lambda: adam_polish_optimizers(device, smi),
             "backend_names": lambda: jax_backend_names(device, smi)}
    res, seconds = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        res[name] = run()
        seconds[name] = time.perf_counter() - t0
    print(json.dumps({"phase12_part_e_seconds": seconds, "card": smi}), flush=True)
    return res


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Fails here when run outside the repository.
    from blackbox_mpc_torch.core.device import resolve_device
    from blackbox_mpc_torch.ops import _build

    t_start = time.perf_counter()
    with phase_timer("1"):
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
        torch.backends.cudnn.allow_tf32 = False
        device = resolve_device(None)
        smi = nvidia_smi()
        print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if "--block-gemm" in sys.argv[1:]:  # phase 3's block layer alone
        with phase_timer("2"):
            log = _build.build("block_gemm")["block_gemm"]
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"block_gemm: {line.strip()}")
        block_gemm_cases(device)
        rssm_act_drive(device)
        return 0
    if "--vjepa2" in sys.argv[1:]:  # phase 5's V-JEPA 2-AC drive alone
        with phase_timer("5"):
            vjepa2_act_drive(device)
        print(json.dumps({"phase_seconds": PHASE_SECONDS}))
        return 0
    if "--compiled-flagship" in sys.argv[1:]:  # phase 11 Part A alone, at the flagship
        with tempfile.TemporaryDirectory() as workdir:
            compiled_cache_times(*compiled_cache_on_card(device, workdir, COMPILED_FLAGSHIP))
        print(smi)
        return 0

    with phase_timer("2"):
        logs = _build.build("rollout", "fused_cem", "block_gemm")
    print(json.dumps({"build_s": PHASE_SECONDS["2"],
                      "compiled": sorted(name for name, log in logs.items() if log)}), flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"{name}: {line.strip()}")

    with phase_timer("3"):
        cases = [kernel_vs_plain(device, p, d)
                 for p, d in (("mean", "float32"), ("mean", "bfloat16"), ("ts1", "float32"),
                              ("ts_inf", "float32"))]
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
        block_line = block_gemm_cases(device)
    with phase_timer("4"):
        small_reference(device)
    with phase_timer("5"):
        kernel_run = drive_policy(device, "kernel", STEPS)
        fused_run = drive_policy(device, "fused", STEPS)
        family = {label: drive_policy(device, "fused", STEPS, label) for label in FUSED_FAMILY}
        drive_policy(device, "eager", 3)
        rssm_run = rssm_act_drive(device)
        vjepa2_act_drive(device)
    with phase_timer("6"):
        mbrl = {backend: mbrl_loop(device, backend) for backend in ("kernel", "fused")}
    with phase_timer("7A"):
        pets = {label: pets_act(device, label) for label in PETS_DRIVES}
        pets_kernel = pets_kernel_act(device)
        pets_rollout_card_vs_cpu(device)
    with phase_timer("7B"):
        pets_trained = pets_loop(device)["handler"]
    with phase_timer("8A"):
        first_order = first_order_drives(device)
    with phase_timer("8B"):
        on_kernels = kernel_solver_drives(device)
    with phase_timer("8C"):
        pipeline_runs(device)
    with phase_timer("8D"):
        bc_loop(device)
    print(json.dumps({"phase8_act_ms_median": {
        label: run["act_ms_median"] for part in (first_order, on_kernels)
        for label, run in part["drives"].items()}, "card": smi}), flush=True)
    print(json.dumps({"pets_act_ms_median": {label: run["act_ms_median"]
                                             for label, run in pets.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"act_ms_median": {
        "kernel": kernel_run["act_ms_median"], "fused": fused_run["act_ms_median"],
        **{label: run["act_ms_median"] for label, run in family.items()}}}), flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        ninth = phase9(device, workdir, mbrl["fused"]["handler"], pets_trained)
    with tempfile.TemporaryDirectory() as workdir:
        tenth = phase10(device, mbrl["fused"]["handler"], workdir,
                        ninth["auto"]["memory"]["peak_per_candidate_byte"]["eager"])
    # Phase 11: Part B's tutorials run while Part A exports and compiles (both compile on the
    # host), and end before Part A's timings.
    cxx_with_openmp()  # the deploy tutorial compiles too
    with tempfile.TemporaryDirectory() as workdir, tutorials_running() as started:
        with phase_timer("11A"):
            part_a, policies = compiled_cache_on_card(device, workdir)
        tutorials_part = finish_tutorials(started)
        PHASE_SECONDS["11B"], tutorials = tutorials_part["seconds"], tutorials_part["tutorials"]
        with phase_timer("11A"):
            compiled_cache_times({**part_a, "compiled_beside": list(TUTORIALS_ON_CARD)},
                                 policies)
    with tempfile.TemporaryDirectory() as workdir:
        twelfth = phase12(device, workdir, {
            **{label: run["act_ms_median"] for label, run in pets.items()},
            "Gradient + proposer": first_order["drives"]["Gradient + proposer"][
                "act_ms_median"]})
    # The launches of each kernel on each path that runs it: phase 5's drives, phase 9's,
    # phase 10's, phase 11's tutorials and phase 12's resumed JAX loop.
    paths = {"kernel CEM act()": kernel_run["launches"],
             "fused CEM act()": fused_run["launches"],
             "fused iCEM act()": family["fused iCEM"]["launches"],
             "auto -> kernel act()": ninth["auto"]["auto_kernel_launches"],
             "auto -> fused act()": ninth["auto"]["auto_fused_launches"],
             "auto -> kernel PETS ts_inf act()": pets_kernel["launches"],
             "device episode, fused CEM": ninth["episodes"]["fused CEM, flagship model"][
                 "launches"],
             "sharded fused CEM act() (1-rank NCCL)": tenth["part_a"]["CEM"]["launches"],
             "sharded fused RandomSearch act() (1-rank NCCL)":
                 tenth["part_a"]["RandomSearch"]["launches"],
             **{f"tutorial {name}": run["launches"] for name, run in tutorials.items()},
             **{f"resumed JAX loop, {backend}, {RESUME_STEPS} steps": run["launches"]
                for backend, run in twelfth["part_c"].items()},
             "RSSM first act() (eager evaluation, capture)": rssm_run["first_launches"],
             "RSSM graphed act() (host; device per act(): 2 a core step)": rssm_run["launches"]}

    print(json.dumps({"phase_seconds": {**PHASE_SECONDS,
                                        "total": time.perf_counter() - t_start},
                      "card": smi}), flush=True)
    # The first case of each kernel is mean/f32 (K6: the 50-elite mask; draw_rows: the iCEM
    # shape), as the policy ran. K6's and draw_rows' ms is the device's, host_ms the host's.
    entries = [
        ("rollout_states", "rollout.cu", "pallas_rollout.py:73", kernel_run, cases[0]),
        ("fused_rollout", "fused_cem.cu", "pallas_cem.py:338", fused_run, fused[0]),
        ("fused_rollout_streamed", "fused_cem.cu", "pallas_cem.py:404", fused_run, streamed),
        ("elite_moments", "fused_cem.cu", "pallas_cem.py:485", fused_run, moments[0]),
        ("draw_rows", "fused_cem.cu", "pallas_cem.py:168", family["fused iCEM"], draws),
        # B1 replaces no Pallas kernel; its case: size200m's core_hidden at 1000 rows.
        ("block_gemm", "block_gemm.cu", None, rssm_run,
         {**block_line["block_gemm"][0], "plain_ms": None, "bound_by": "ops"}),
    ]
    # K2's ts_inf instantiation at PETS' shape, beside its mean/f32 case.
    ts_inf = {key: cases[3][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "rows")}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"blackbox_mpc_torch/ops/csrc/{source}",
        "replaces": None if replaces is None else f"blackbox_mpc_tpu/ops/{replaces}",
        "launches": run["launches"][name],
        "max_abs_err": case["max_abs_err"],
        "ms": case["ms"],
        "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"],
        "library_ms": case.get("library_ms"),
        **({"host_ms": case["host_ms"]} if "host_ms" in case else {}),
        **({"ts_inf": ts_inf} if name == "rollout_states" else {}),
        **({"shapes": block_line["block_gemm"],
            "device_launches_per_act": rssm_run["device_launches_per_act"]}
           if name == "block_gemm" else {}),
        "launches_by_path": {path: counts[name] for path, counts in paths.items()
                             if counts.get(name)},
    } for name, source, replaces, run, case in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
