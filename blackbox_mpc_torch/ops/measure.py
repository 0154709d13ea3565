"""Times the kernels at the flagship shape on one NVIDIA GPU: the tile sweep behind
``TILE_MEAN``/``TILE_TS1`` and the comparison of two source trees in turns.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 blackbox_mpc_torch/ops/measure.py cases [--tree DIR] [--tile-mean N] [--tile-ts1 N]
        [--tile-ts-inf N] [--only ts_inf]
    python3 blackbox_mpc_torch/ops/measure.py sweep --mean 24 32 40 48 --ts1 4 8 16
    python3 blackbox_mpc_torch/ops/measure.py sweep --ts-inf 24 32 40 48 --only ts_inf
    python3 blackbox_mpc_torch/ops/measure.py compare --parent DIR [--rounds 2]

``cases`` times one tree (``DIR`` holds ``blackbox_mpc_torch/`` and ``chip_smoke.py``; default
the current directory) and prints one JSON line: per case the kernel's ms per launch, its
occupancy where the tree reports it, and for K2 the error against the plain version. The
inputs are ``chip_smoke.py``'s flagship inputs of that tree, rows padded to the tree's tile.
The cases: K2, K4 (white and with the iCEM options) and K5; K6 with a 50-elite mask, softmax
weights, the mask with the iCEM options and softmax with the clip, each as the host's time
of a call and the device's (:func:`graph_ms`); and the draw of five carried colored elites
(``draw_rows``, or in a tree without it the plain ``_mirror_z``), host and device. In a tree
whose K2 runs ts_inf, the PETS cases (:func:`ts_inf_cases`): K2 ts_inf at PETS' shape, and
the kernel evaluator against the graphed eager evaluator over populations of 50 to 1000.
``--tile-mean``/``--tile-ts1``/``--tile-ts-inf`` build the kernels with other tiles
(``-DBBMPC_TILE_MEAN=N``); ``--only ts_inf`` runs the PETS cases alone. ``sweep`` runs
``cases`` once per tile; ``compare`` runs parent, change, change, parent (times
``--rounds``), each in a process of its own, and prints every time and the medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """The device's ms per call: ``calls`` calls captured in a CUDA graph, the graph replayed
    ``replays`` times between two events, so that no host work lies between the launches."""
    import torch

    fn()  # warm up: build and load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _pad_rows(x, rows: int, dim: int):
    import torch

    return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, rows - x.shape[dim]])


# PETS' shape (port_bench/configs/pets_halfcheetah.json): S=18, U=6, 4 x 200 swish, 5 members
# with Gaussian heads and learned log-variance bounds, TS-infinity with 20 particles; CEM's 500
# candidates over H=30.
PETS = dict(dim_s=18, dim_u=6, hidden=(200, 200, 200, 200), activation="swish",
            ensemble_size=5, probabilistic=True, learn_logvar_bounds=True, propagation="ts_inf",
            num_particles=20)
PETS_POPULATION, PETS_HORIZON = 500, 30


def pets_params(config, device, seed: int = 3):
    """PETS' net from ``seed``: weights normal at gain 1.4 / sqrt(fan_in) and small biases,
    normalizer statistics at the laws of ``port_bench/configs/pets_halfcheetah.json``, and
    log-variance bounds drawn near PETS' start (-10, 0.5)."""
    import torch

    from blackbox_mpc_torch.models.dynamics import DynamicsParams, make_learned_dynamics
    from blackbox_mpc_torch.models.normalizer import NormalizerStats

    g = torch.Generator().manual_seed(seed)
    layers = make_learned_dynamics(config)[0](g).params["net"]
    layers = [{"w": torch.randn(layer["w"].shape, generator=g) * 1.4 / layer["w"].shape[1] ** 0.5,
               "b": 0.1 * torch.randn(layer["b"].shape, generator=g)} for layer in layers]
    s, u = config.dim_s, config.dim_u

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    stats = NormalizerStats(torch.randn(s, generator=g), uniform(s, 0.5, 2.0),
                            0.3 * torch.randn(u, generator=g), uniform(u, 0.5, 1.5),
                            0.05 * torch.randn(s, generator=g), uniform(s, 0.05, 0.2))
    params = {"net": layers, "lv_min": uniform(s, -10.0, -9.0), "lv_max": uniform(s, -0.5, 0.5)}
    return DynamicsParams(params=params, stats=stats).to(device)


def pets_launch(rk, device, seed: int = 11):
    """One K2 ts_inf launch at PETS' shape, laid out as the kernel evaluator lays it out:
    ``(config, dp, args)`` with ``args = (config, operands, actions [H, rows, U], s0 [rows, S],
    tile_member, noise [H, rows, S])`` for ``rk.rollout_states`` and its plain version. The
    10 000 particle rows are member-major, each member's 2000 padded to whole tiles; H=30.
    Normal actions clipped to [-1, 1], states and noise from ``seed``. ``rk``: the tree's
    ``ops/rollout_kernel.py``."""
    import torch

    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig

    config = LearnedDynamicsConfig(**PETS)
    dp = pets_params(config, device)
    ensemble, tile = config.ensemble_size, rk.TILE_TS_INF
    per = PETS_POPULATION * config.num_particles // ensemble
    block = -(-per // tile) * tile
    g = torch.Generator(device=device).manual_seed(seed)

    def rows(width, steps=PETS_HORIZON):
        x = torch.randn((steps, ensemble, per, width), generator=g, device=device)
        return _pad_rows(x, block, 2).reshape(steps, ensemble * block, width).contiguous()

    acts, noise = rows(config.dim_u).clamp(-1, 1), rows(config.dim_s)
    s0 = rows(config.dim_s, 1)[0]
    member = torch.arange(ensemble, dtype=torch.int32, device=device)
    member = member.repeat_interleave(block // tile)
    return config, dp, (config, rk.make_operands(dp, config), acts, s0, member, noise)


def ts_inf_cases(cs, rk, device, reps: int) -> dict:
    """K2 ts_inf at PETS' shape (:func:`pets_launch`): ms per launch, occupancy and the error
    against the plain version, and the plain version's ms; then per population the kernel
    evaluator's ms per evaluation against the graphed eager evaluator's (the path it
    replaces), and their widest gap."""
    import torch

    from blackbox_mpc_torch.deploy.serving import tree_leaves
    from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
    from blackbox_mpc_torch.rollout.evaluator import GraphedEvaluator, make_trajectory_evaluator

    config, dp, args = pets_launch(rk, device)
    s, u, horizon, rows = config.dim_s, config.dim_u, PETS_HORIZON, args[2].shape[1]
    g = torch.Generator(device=device).manual_seed(12)

    def launch():
        return rk.rollout_states(*args)

    def plain():
        return rk.rollout_states_plain(*args)

    states, ref = launch(), plain()
    err = float((states - ref).abs().max() / max(1.0, float(ref.abs().max())))
    case = {"ms": cs.cuda_ms(launch, reps), "plain_ms": cs.cuda_ms(plain, 2),
            "rows": rows, "state_max_rel_err": err}
    case.update(rk.kernel_occupancy(config, rows))
    out = {"K2 ts_inf/float32": case}

    def reward(st, a, ns):
        return ns[:, 0] - 0.1 * (a * a).sum(-1)

    dyn = make_learned_dynamics(config)[1]
    kernel = rk.make_rollout_kernel_evaluator(config, reward, device=device)
    eager = GraphedEvaluator(
        make_trajectory_evaluator(lambda st, a, n=None: dyn(dp, st, a, n), reward,
                                  num_particles=config.num_particles, device=device),
        lambda: tree_leaves(dp))
    obs = torch.randn((1, s), generator=g, device=device)
    with torch.no_grad():
        for population in (50, 100, 250, 500, 1000):
            cand = torch.rand((population, 1, horizon, u), generator=g, device=device) * 2 - 1
            eps = torch.randn((horizon, population * config.num_particles, s), generator=g,
                              device=device)
            got, want = kernel(dp, obs, cand, eps), eager(obs, cand, eps)
            out[f"ts_inf evaluation P={population}"] = {
                "kernel_ms": cs.cuda_ms(lambda: kernel(dp, obs, cand, eps), reps),
                "eager_graphed_ms": cs.cuda_ms(lambda: eager(obs, cand, eps), reps),
                "particle_rows": population * config.num_particles,
                "max_abs_gap": float((got - want).abs().max()),
                "max_abs_return": float(want.abs().max())}
    return out


def run_cases(tree: str, tile_mean: int | None, tile_ts1: int | None, reps: int,
              tile_ts_inf: int | None = None, only: str | None = None) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_torch.ops import _build
    from blackbox_mpc_torch.ops import fused_cem as fc
    from blackbox_mpc_torch.ops import rollout_kernel as rk

    if tile_mean is not None:
        rk.TILE_MEAN = tile_mean
        _build.NVCC_FLAGS += (f"-DBBMPC_TILE_MEAN={tile_mean}",)
    if tile_ts1 is not None:
        rk.TILE_TS1 = tile_ts1
        _build.NVCC_FLAGS += (f"-DBBMPC_TILE_TS1={tile_ts1}",)
    if tile_ts_inf is not None:
        rk.TILE_TS_INF = tile_ts_inf
        _build.NVCC_FLAGS += (f"-DBBMPC_TILE_TS_INF={tile_ts_inf}",)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    ts_inf = hasattr(rk, "TILE_TS_INF")

    def tile_of(ts1: bool) -> int:
        return rk.tile_rows(ts1) if hasattr(rk, "tile_rows") else rk.TILE

    tiles = {"mean": tile_of(False), "ts1": tile_of(True)}
    if ts_inf:
        tiles["ts_inf"] = rk.TILE_TS_INF
    out = {"tree": tree, "device": cs.nvidia_smi(), "tiles": tiles, "cases": {}}
    if only == "ts_inf":
        _build.build("rollout")
        if ts_inf:
            out["cases"].update(ts_inf_cases(cs, rk, device, reps))
        return out
    _build.build("rollout", "fused_cem")
    rows, horizon = cs.ROWS, cs.HORIZON
    g = np.random.default_rng(2)
    acts0 = torch.as_tensor(g.uniform(-1, 1, (horizon, rows, 6)), dtype=torch.float32,
                            device=device)
    s00 = torch.as_tensor(g.normal(0, 1, (rows, 17)), dtype=torch.float32, device=device)
    for propagation, dtype in (("mean", "float32"), ("mean", "bfloat16"), ("ts1", "float32")):
        config = LearnedDynamicsConfig(**cs.FLAGSHIP, propagation=propagation,
                                       compute_dtype=getattr(torch, dtype))
        ops = rk.make_operands(cs.flagship_params(config, device), config)
        ts1 = propagation == "ts1"
        tile = tile_of(ts1)
        # K2: ts1 rows are member-major blocks of whole tiles, as the evaluator lays them.
        if ts1:
            per = rows // config.ensemble_size
            block = -(-per // tile) * tile
            acts = _pad_rows(acts0.reshape(horizon, config.ensemble_size, per, 6), block, 2)
            acts = acts.reshape(horizon, -1, 6).contiguous()
            s0 = _pad_rows(s00.reshape(config.ensemble_size, per, 17), block, 1)
            s0 = s0.reshape(-1, 17).contiguous()
            member = torch.arange(config.ensemble_size, dtype=torch.int32, device=device)
            member = member.repeat_interleave(block // tile)
        else:
            padded = -(-rows // tile) * tile
            acts = _pad_rows(acts0, padded, 1).contiguous()
            s0 = _pad_rows(s00, padded, 0).contiguous()
            member = None
        states = rk.rollout_states(config, ops, acts, s0, member)
        ref = rk.rollout_states_plain(config, ops, acts, s0, member)
        err = float((states - ref).abs().max() / max(1.0, float(ref.abs().max())))
        case = {"ms": cs.cuda_ms(lambda: rk.rollout_states(config, ops, acts, s0, member), reps),
                "rows": acts.shape[1], "state_max_rel_err": err}
        if hasattr(rk, "occupancy_report"):
            case.update(rk.kernel_occupancy(config, acts.shape[1]))
        out["cases"][f"K2 {propagation}/{dtype}"] = case

        # K4 (and K5 for mean/f32): one agent, the logical ts1 tile of chip_smoke.py.
        g4 = np.random.default_rng(4)
        hu = horizon * config.dim_u
        a0 = torch.as_tensor(g4.normal(0, 1, (1, 17)), dtype=torch.float32, device=device)
        mean = torch.as_tensor(g4.uniform(-0.3, 0.3, (1, hu)), dtype=torch.float32, device=device)
        std = torch.as_tensor(g4.uniform(0.2, 0.5, (1, hu)), dtype=torch.float32, device=device)
        seed = torch.tensor([1234567891], dtype=torch.int32, device=device)
        padded = -(-rows // tile) * tile
        tm, member_tile = None, tile
        if ts1:
            rr, _ = fc.make_fused_cem_kernels(config, cs.reward_fn, horizon=horizon, agents=1,
                                              population=rows, tile=cs.FUSED_TILE)
            tm = torch.as_tensor(rr.tile_member_ids, device=device)
            member_tile = cs.FUSED_TILE
        variants = [("K4", fc.fused_rollout, {})]
        if (propagation, dtype) == ("mean", "float32"):
            variants.append(("K5", fc.fused_rollout_streamed, {}))
            variants.append(("K4 icem", fc.fused_rollout,
                             {"features": cs.flagship_features(device, "icem")}))
        for name, fn, more in variants:
            def launch(fn=fn, more=more):
                return fn(config, ops, a0, mean, std, seed, padded, tm, member_tile, **more)

            case = {"ms": cs.cuda_ms(launch, reps), "rows": padded}
            if hasattr(fc, "fused_occupancy"):
                case.update(fc.fused_occupancy(config, padded, horizon, streamed=name == "K5"))
            out["cases"][f"{name} {propagation}/{dtype}"] = case
    out["cases"].update(k3_k6_cases(cs, fc, device, reps))
    if ts_inf:
        out["cases"].update(ts_inf_cases(cs, rk, device, reps))
    torch.cuda.synchronize()
    return out


def k3_k6_cases(cs, fc, device, reps: int) -> dict:
    """K6 at the flagship (one agent, population 1000, H*U = 300) and the draw of five carried
    elites, each as the host's ms per call (back-to-back calls) and the device's."""
    import numpy as np
    import torch

    hu = cs.HORIZON * 6
    g = np.random.default_rng(5)
    std = torch.as_tensor(g.uniform(0.2, 0.5, (1, hu)), dtype=torch.float32, device=device)
    mean = torch.as_tensor(g.uniform(-0.3, 0.3, (1, hu)), dtype=torch.float32, device=device)
    seed = torch.tensor([987654321], dtype=torch.int32, device=device)
    mask = np.zeros(cs.ROWS, np.float32)
    mask[g.choice(cs.ROWS, 50, replace=False)] = 1.0
    e = np.exp(g.normal(0, 3, cs.ROWS))
    softmax = (e / e.sum()).astype(np.float32)
    cases = {}
    for label, w, options in (("mask", mask, None), ("softmax", softmax, None),
                              ("mask icem", mask, "icem"), ("softmax clip", softmax, "clip")):
        w = torch.as_tensor(w, device=device)
        features = cs.flagship_features(device, options) if options else None

        def k6(w=w, features=features):
            return fc.elite_moments(std, w, seed, mean, features)

        cases[f"K6 {label} host"] = {"ms": cs.cuda_ms(k6, 10 * reps)}
        cases[f"K6 {label} device"] = {"ms": graph_ms(k6)}
    icem = cs.flagship_features(device, "icem")
    rows = torch.tensor([3, 150, 402, 777, 998], device=device)
    if hasattr(fc, "draw_rows"):
        def draw():
            return fc.draw_rows(seed, rows, hu, icem.basis)
    else:
        def draw():
            return fc._mirror_z(seed, rows, hu, icem.basis2)
    cases["K3 5 colored rows host"] = {"ms": cs.cuda_ms(draw, 10 * reps)}
    cases["K3 5 colored rows device"] = {"ms": graph_ms(draw)}
    return cases


def _cases_subprocess(tree: str, more: list) -> dict:
    cmd = [sys.executable, __file__, "cases", "--tree", tree, *more]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    cases = sub.add_parser("cases")
    cases.add_argument("--tree", default=".")
    cases.add_argument("--tile-mean", type=int)
    cases.add_argument("--tile-ts1", type=int)
    cases.add_argument("--tile-ts-inf", type=int)
    cases.add_argument("--only", choices=["ts_inf"])
    cases.add_argument("--reps", type=int, default=5)
    sweep = sub.add_parser("sweep")
    sweep.add_argument("--mean", type=int, nargs="*", default=[])
    sweep.add_argument("--ts1", type=int, nargs="*", default=[])
    sweep.add_argument("--ts-inf", type=int, nargs="*", default=[])
    sweep.add_argument("--only", choices=["ts_inf"])
    compare = sub.add_parser("compare")
    compare.add_argument("--parent", required=True)
    compare.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()

    if args.command == "cases":
        print(json.dumps(run_cases(args.tree, args.tile_mean, args.tile_ts1, args.reps,
                                   args.tile_ts_inf, args.only)))
        return 0
    if args.command == "sweep":
        # Each run builds one tile of each kind; the shorter lists repeat their last.
        n = max(len(args.mean), len(args.ts1), len(args.ts_inf))
        for i in range(n):
            more = ["--only", args.only] if args.only else []
            for flag, tiles in (("--tile-mean", args.mean), ("--tile-ts1", args.ts1),
                                ("--tile-ts-inf", args.ts_inf)):
                if tiles:
                    more += [flag, str(tiles[min(i, len(tiles) - 1)])]
            try:
                print(json.dumps(_cases_subprocess(".", more)), flush=True)
            except RuntimeError as exc:  # a tile that does not build or launch: say so, go on
                print(json.dumps({"tiles": more, "failed": str(exc)[-1500:]}), flush=True)
        return 0
    turns = ["parent", "change", "change", "parent"] * args.rounds
    times: dict = {}
    for turn in turns:
        res = _cases_subprocess(args.parent if turn == "parent" else ".", [])
        print(json.dumps({"turn": turn, **res}), flush=True)
        for case, values in res["cases"].items():
            if "ms" not in values:  # an evaluation case: its times are in its own line
                continue
            times.setdefault(case, {"parent": [], "change": []})[turn].append(values["ms"])
    print(json.dumps({"compare_ms": {
        case: {turn: {"runs": runs, "median": statistics.median(runs)}
               for turn, runs in by_turn.items() if runs}  # a case one tree lacks
        for case, by_turn in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
