"""Smoke test of the PyTorch/CUDA port (blackbox_mpc_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package. Phases, each fatal on failure:

1. device: print the card's name and power limit (``nvidia-smi``); no CUDA -> exit 2.
2. build: compile the port's CUDA source with ``nvcc``.
3. kernel vs plain at the flagship shape (rows=1000, H=50, a 5-member 3x500 tanh ensemble,
   S=17, U=6, seeded random weights, non-trivial normalizer stats): the rollout kernel (K2
   with K1 inside) against its plain PyTorch version on the same inputs, for mean/f32,
   mean/bf16 and ts1/f32. Both the whole visited-state tensor [H, rows, S] and the rewards
   summed from it are held to stated tolerances; times of both and the analytic bound.
4. reference on a small input: the kernel evaluator against the eager evaluator.
5. slice: ``MPCPolicy(rollout_backend="kernel")`` with CEM at the flagship settings
   (pop=1000, 5 iterations, 50 elites) acts 5 steps, closing the loop through the model;
   actions must be finite and in bounds, and the kernel's launch count over exactly that
   run must be steps x iterations. The same for the eager backend, timed.

The line before the last two is ``{"kernels": [...]}``; then the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FLAGSHIP = dict(dim_s=17, dim_u=6, hidden=(500, 500, 500), ensemble_size=5)
ROWS, HORIZON, STEPS, ITERS = 1000, 50, 5, 5
# Max |kernel - plain| over the visited states and over the rewards, each relative to
# max(1, max |plain|). f32: the kernel's FMA order differs from cuBLAS's (measured ~1e-7
# relative); bf16: one rounded activation may land 1 ulp (2^-8) apart and propagate through
# 50 steps (measured ~2e-4 relative).
TOLERANCE = {"float32": 1e-4, "bfloat16": 1e-2}
H100_PEAK = {"float32": 67e12, "bfloat16": 989e12}  # dense FLOP/s, SXM, 700 W
H100_BYTES_PER_S = 3.35e12


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
    import torch

    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def bound(config, rows: int, horizon: int, members: int) -> tuple[float, str]:
    """Least time for one launch: max(bytes moved / HBM rate, FLOPs / peak), in ms."""
    import torch

    sizes = [config.dim_s + config.dim_u, *config.hidden, config.dim_s]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    flops = 2.0 * macs * members * rows * horizon
    itemsize = torch.tensor([], dtype=config.compute_dtype).element_size()
    n_bias = sum(sizes[1:])
    bytes_moved = (
        4 * horizon * rows * config.dim_u + 4 * rows * config.dim_s  # actions, s0 in
        + config.ensemble_size * (macs * itemsize + 4 * n_bias)  # weights, biases in
        + 4 * 6 * max(config.dim_s, config.dim_u)  # stats in
        + 4 * horizon * rows * config.dim_s  # states out
    )
    dtype = "bfloat16" if config.compute_dtype == torch.bfloat16 else "float32"
    t_ops = flops / H100_PEAK[dtype] * 1e3
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_vs_plain(device, propagation: str, dtype: str) -> dict:
    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    config = LearnedDynamicsConfig(**FLAGSHIP, propagation=propagation,
                                   compute_dtype=getattr(torch, dtype))
    ops = rk.make_operands(flagship_params(config, device), config)
    g = np.random.default_rng(2)
    acts = torch.as_tensor(g.uniform(-1, 1, (HORIZON, ROWS, config.dim_u)), dtype=torch.float32,
                           device=device)
    s0 = torch.as_tensor(g.normal(0, 1, (ROWS, config.dim_s)), dtype=torch.float32,
                         device=device)
    member = None
    members = config.ensemble_size
    if propagation == "ts1":
        # 200 rows per member: whole tiles, so the member-major blocks need no padding.
        member = torch.arange(config.ensemble_size, dtype=torch.int32, device=device)
        member = member.repeat_interleave(ROWS // config.ensemble_size // rk.TILE)
        members = 1

    def kernel():
        return rk.rollout_states(config, ops, acts, s0, member)

    def plain():
        return rk.rollout_states_plain(config, ops, acts, s0, member)

    states, ref_states = kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(states).all()):
        raise AssertionError(f"{propagation}/{dtype}: kernel states not finite")
    got, ref = rewards_from_states(s0, acts, states), rewards_from_states(s0, acts, ref_states)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    state_err = float((states - ref_states).abs().max())
    state_scale = max(1.0, float(ref_states.abs().max()))
    bound_ms, bound_by = bound(config, ROWS, HORIZON, members)
    res = {
        "case": f"{propagation}/{dtype}", "tile": rk.TILE, "grid": ROWS // rk.TILE,
        **rk.kernel_occupancy(config),
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


def small_reference(device) -> None:
    """Kernel evaluator vs the eager evaluator on a small input (f32, rtol/atol 1e-4)."""
    from functools import partial

    import numpy as np
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
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


def drive_policy(device, backend: str, steps: int) -> dict:
    import numpy as np
    import torch

    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    config = LearnedDynamicsConfig(**FLAGSHIP, propagation="mean")
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(flagship_params(config, device))
    policy = MPCPolicy(
        BoxSpace.of(-1.0, 1.0, dim=6), reward_fn, handler, rollout_backend=backend,
        planning_horizon=HORIZON, population=ROWS, num_elite=50, max_iterations=ITERS,
        seed=0, device=device,
    )
    obs = np.zeros(17, np.float32)
    policy.act(obs)  # warm-up: first-use costs (kernel load, cuBLAS handles)
    rk.rollout_states.launches = 0
    times = []
    for t in range(steps):
        t0 = time.perf_counter()
        action, obs, reward = policy.act(obs, t)  # returns host arrays: synchronised
        times.append((time.perf_counter() - t0) * 1e3)
        if not (np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)):
            raise AssertionError(f"{backend}: action out of bounds or not finite: {action}")
        if not (np.all(np.isfinite(obs)) and np.isfinite(reward)):
            raise AssertionError(f"{backend}: predicted next obs/reward not finite")
    launches = rk.rollout_states.launches
    expected = steps * ITERS if backend == "kernel" else 0
    if launches != expected:
        raise AssertionError(f"{backend}: {launches} kernel launches, expected {expected}")
    res = {"policy": backend, "steps": steps, "launches": launches,
           "act_ms": times, "act_ms_median": float(np.median(times)),
           "last_action": [float(a) for a in action], "last_predicted_reward": float(reward)}
    print(json.dumps(res), flush=True)
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
    log = _build.build("rollout")
    print(json.dumps({"build_s": time.perf_counter() - t0, "compiled": bool(log)}), flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"rollout: {line.strip()}")

    cases = [kernel_vs_plain(device, p, d)
             for p, d in (("mean", "float32"), ("mean", "bfloat16"), ("ts1", "float32"))]
    small_reference(device)
    kernel_run = drive_policy(device, "kernel", STEPS)
    drive_policy(device, "eager", 3)

    main_case = cases[0]  # mean/f32: the configuration the policy ran
    print(json.dumps({"kernels": [{
        "name": "rollout_states",
        "route": "cuda",
        "source": "blackbox_mpc_torch/ops/csrc/rollout.cu",
        "replaces": "blackbox_mpc_tpu/ops/pallas_rollout.py:73",
        "launches": kernel_run["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
