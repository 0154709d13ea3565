"""Times the kernels at the flagship shape on one NVIDIA GPU: the tile sweep behind
``TILE_MEAN``/``TILE_TS1`` and the comparison of two source trees in turns.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 blackbox_mpc_torch/ops/measure.py cases [--tree DIR] [--tile-mean N] [--tile-ts1 N]
    python3 blackbox_mpc_torch/ops/measure.py sweep --mean 24 32 40 48 --ts1 4 8 16
    python3 blackbox_mpc_torch/ops/measure.py compare --parent DIR [--rounds 2]

``cases`` times one tree (``DIR`` holds ``blackbox_mpc_torch/`` and ``chip_smoke.py``; default
the current directory) and prints one JSON line: per case the kernel's ms per launch, its
occupancy where the tree reports it, and for K2 the error against the plain version. The
inputs are ``chip_smoke.py``'s flagship inputs of that tree, rows padded to the tree's tile.
The cases: K2, K4 (white and with the iCEM options) and K5; K6 with a 50-elite mask, softmax
weights, the mask with the iCEM options and softmax with the clip, each as the host's time
of a call and the device's (:func:`graph_ms`); and the draw of five carried colored elites
(``draw_rows``, or in a tree without it the plain ``_mirror_z``), host and device.
``--tile-mean``/``--tile-ts1`` build the kernels with other tiles (``-DBBMPC_TILE_MEAN=N``).
``sweep`` runs ``cases`` once per tile; ``compare`` runs parent, change, change, parent (times
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


def run_cases(tree: str, tile_mean: int | None, tile_ts1: int | None, reps: int) -> dict:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    _build.build("rollout", "fused_cem")

    def tile_of(ts1: bool) -> int:
        return rk.tile_rows(ts1) if hasattr(rk, "tile_rows") else rk.TILE

    rows, horizon = cs.ROWS, cs.HORIZON
    out = {"tree": tree, "device": cs.nvidia_smi(),
           "tiles": {"mean": tile_of(False), "ts1": tile_of(True)}, "cases": {}}
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
    cases.add_argument("--reps", type=int, default=5)
    sweep = sub.add_parser("sweep")
    sweep.add_argument("--mean", type=int, nargs="*", default=[])
    sweep.add_argument("--ts1", type=int, nargs="*", default=[])
    compare = sub.add_parser("compare")
    compare.add_argument("--parent", required=True)
    compare.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()

    if args.command == "cases":
        print(json.dumps(run_cases(args.tree, args.tile_mean, args.tile_ts1, args.reps)))
        return 0
    if args.command == "sweep":
        # Each run builds one mean tile and one ts1 tile; the shorter list repeats its last.
        n = max(len(args.mean), len(args.ts1))
        for i in range(n):
            more = []
            if args.mean:
                more += ["--tile-mean", str(args.mean[min(i, len(args.mean) - 1)])]
            if args.ts1:
                more += ["--tile-ts1", str(args.ts1[min(i, len(args.ts1) - 1)])]
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
            times.setdefault(case, {"parent": [], "change": []})[turn].append(values["ms"])
    print(json.dumps({"compare_ms": {
        case: {turn: {"runs": runs, "median": statistics.median(runs)}
               for turn, runs in by_turn.items()}
        for case, by_turn in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
