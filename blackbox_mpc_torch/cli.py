"""Command-line interface: quick MPC runs without writing a script.

Counterpart of ``blackbox_mpc_tpu/cli.py``, with its subcommands, flags, exit codes and JSON
lines. Every command runs on ``cuda`` unless ``--cpu`` is given.

    python -m blackbox_mpc_torch solve --env pendulum --solver CEM --steps 100
    python -m blackbox_mpc_torch learn --env Pendulum-v1 --refinements 3
    python -m blackbox_mpc_torch export --env pendulum -o ctrl.bbmpc
    python -m blackbox_mpc_torch serve ctrl.bbmpc
    python -m blackbox_mpc_torch solvers
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--solver", default="CEM")
    p.add_argument("--planning-horizon", type=int, default=25)
    p.add_argument("--population", type=int, default=512)
    p.add_argument("--iterations", type=int, default=5)
    p.add_argument("--num-envs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    p.add_argument(
        "--smoothness", type=float, default=0.0, metavar="W",
        help="actuation-rate cost: subtract W * sum ||a_t - a_{t-1}||^2 from candidate returns",
    )
    p.add_argument(
        "--time-major", action="store_true",
        help="sample/evaluate candidates [H, P, A, U] "
             "(CEM/CEM-GD/PI2/MPPI/PSO/RandomSearch/SPSA)",
    )


def _device(args):
    """``--cpu`` -> ``"cpu"``; otherwise None, which every entry point reads as ``cuda``."""
    return "cpu" if args.cpu else None


def cmd_solvers(_args):
    from blackbox_mpc_torch.solvers import SOLVER_REGISTRY

    for name, (cfg_cls, _) in sorted(SOLVER_REGISTRY.items()):
        fields = {
            f: getattr(cfg_cls(), f)
            for f in cfg_cls.__dataclass_fields__
            if f not in ("dtype",)
        }
        print(f"{name}: {fields}")
    return 0


def cmd_solve(args):
    from blackbox_mpc_torch import DynamicsHandler, MPCPolicy, perform_rollouts
    from blackbox_mpc_torch.models import ANALYTIC_MODELS

    if args.env in ANALYTIC_MODELS:
        dynamics, reward = ANALYTIC_MODELS[args.env]
        if args.env == "pendulum":
            from blackbox_mpc_torch.envs import NativePendulumVecEnv

            env = NativePendulumVecEnv(num_envs=args.num_envs, seed=args.seed)
        elif args.env == "cartpole":
            from blackbox_mpc_torch.envs import NativeCartpoleVecEnv

            env = NativeCartpoleVecEnv(num_envs=args.num_envs, seed=args.seed)
        else:
            print(f"no built-in environment for analytic model {args.env!r}", file=sys.stderr)
            return 2
    else:
        print(
            f"unknown analytic model {args.env!r}; available: {sorted(ANALYTIC_MODELS)}. "
            "For gym envs with learned dynamics use the 'learn' subcommand.",
            file=sys.stderr,
        )
        return 2
    policy = MPCPolicy(
        action_space=env.action_space,
        reward_function=reward,
        dynamics_handler=DynamicsHandler(true_model=dynamics, device=_device(args)),
        solver_name=args.solver,
        num_agents=args.num_envs,
        planning_horizon=args.planning_horizon,
        population=args.population,
        max_iterations=args.iterations,
        seed=args.seed,
        action_smoothness_weight=args.smoothness,
        device=_device(args),
        **({"time_major": True} if args.time_major else {}),
    )
    result = perform_rollouts(
        env, policy, number_of_rollouts=args.rollouts, rollout_horizon=args.steps
    )
    print(
        json.dumps(
            {
                "env": args.env,
                "solver": args.solver,
                "episode_rewards": [round(r, 2) for r in result["reward_sum"]],
                "act_latency": result["latency"],
            }
        )
    )
    return 0


def _reward_for_gym_env(env_name: str):
    """Built-in reward for a gym env name, or the loudly-warned generic surrogate.

    ONE definition shared by `learn` and `export --checkpoint-dir`: a controller trained
    under one objective and exported under a subtly different one would silently plan for
    the wrong thing."""
    from blackbox_mpc_torch.models import ANALYTIC_MODELS

    if env_name == "Pendulum-v1":
        return ANALYTIC_MODELS["pendulum"][1]
    # No analytic reward is known for this env — fall back to a generic locomotion
    # surrogate. This is almost certainly NOT the env's true reward; warn loudly.
    print(
        f"WARNING: no built-in reward function for {env_name!r}; planning with a "
        "generic surrogate reward (obs[0] forward progress - 0.1*||action||^2). "
        "For meaningful control, use the Python API and pass the env's true reward "
        "function.",
        file=sys.stderr,
    )
    import torch

    def reward(s, a, ns):  # generic: forward progress on obs[0] minus control cost
        return ns[:, 0] - s[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)

    return reward


def cmd_learn(args):
    from blackbox_mpc_torch import LearnedDynamicsConfig, learn_dynamics_iteratively_w_mpc
    from blackbox_mpc_torch.envs import make_gym_vec_env

    reward = _reward_for_gym_env(args.env)
    env = make_gym_vec_env(args.env, num_envs=args.num_envs, mode="subprocess",
                           base_seed=args.seed)
    handler, policy = learn_dynamics_iteratively_w_mpc(
        env,
        reward,
        solver_name=args.solver,
        planning_horizon=args.planning_horizon,
        number_of_initial_rollouts=args.initial_rollouts,
        number_of_refinement_steps=args.refinements,
        rollout_horizon=args.steps,
        dynamics_config=LearnedDynamicsConfig(
            dim_s=env.observation_space.dim,
            dim_u=env.action_space.dim,
            hidden=tuple(args.hidden),
        ),
        epochs=args.epochs,
        population=args.population,
        max_iterations=args.iterations,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        device=_device(args),
        # Binds to MPCPolicy's named param through the workflow's **solver_kwargs.
        action_smoothness_weight=args.smoothness,
        **({"time_major": True} if args.time_major else {}),
    )
    env.close()
    print(json.dumps({"env": args.env, "replay_size": len(handler.replay), "done": True}))
    return 0


def cmd_calibrate(args):
    """Variance-calibration check of a trained probabilistic checkpoint.

    Prints the ``learning/calibration.py`` summary as one JSON line: the r5 PETS study
    (docs/performance.md "PETS uncertainty propagation") showed ``E[res^2]/E[sigma^2]``
    drifting away from ~1.0 is the leading indicator of sampled-propagation failure —
    run this before trusting ``propagation="ts_inf"/"mm"`` on a long-trained model.
    """
    import os

    from blackbox_mpc_torch.learning.calibration import calibration_summary
    from blackbox_mpc_torch.learning.handler import DynamicsHandler

    ckpt = args.checkpoint_dir
    if not os.path.exists(os.path.join(ckpt, "config.json")) and os.path.exists(
        os.path.join(ckpt, "handler", "config.json")
    ):
        ckpt = os.path.join(ckpt, "handler")  # MBRL-loop dir: descend to the handler
    try:
        handler = DynamicsHandler.load(ckpt, device=_device(args))
    except FileNotFoundError:
        print(f"error: no checkpoint at {args.checkpoint_dir}", file=sys.stderr)
        return 2
    if handler.config is None or not handler.config.probabilistic:
        print(
            "error: checkpoint's dynamics are deterministic — nothing to calibrate "
            "(train with LearnedDynamicsConfig(probabilistic=True))",
            file=sys.stderr,
        )
        return 2
    summary = calibration_summary(handler)
    if summary is None:
        print("error: checkpoint has no validation split", file=sys.stderr)
        return 2
    ratio = summary["variance_ratio"]
    verdict = (
        "overconfident (sampled noise too small)" if ratio > 1.5 else
        "underconfident (sampled noise too large)" if ratio < 0.67 else
        "approximately calibrated"
    )
    print(json.dumps({
        "checkpoint": args.checkpoint_dir,
        "variance_ratio": round(ratio, 4),
        "coverage_1sigma": round(summary["coverage_1sigma"], 4),
        "coverage_2sigma": round(summary["coverage_2sigma"], 4),
        "gaussian_expected": {"1sigma": 0.6827, "2sigma": 0.9545},
        "val_points": summary["val_points"],
        "per_dim_variance_ratio": [
            round(float(r), 4) for r in summary["per_dim_variance_ratio"]
        ],
        "verdict": verdict,
    }))
    return 0


def cmd_export(args):
    from blackbox_mpc_torch import DynamicsHandler, MPCPolicy, export_policy_artifact
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models import ANALYTIC_MODELS

    if args.checkpoint_dir:
        import os

        # Accept both layouts: a DynamicsHandler.save directory, or an MBRL-loop
        # checkpoint_dir (workflows/iterative_mpc.py nests the handler under handler/).
        ckpt = args.checkpoint_dir
        if not os.path.exists(os.path.join(ckpt, "config.json")) and os.path.exists(
            os.path.join(ckpt, "handler", "config.json")
        ):
            ckpt = os.path.join(ckpt, "handler")
        handler = DynamicsHandler.load(ckpt, device=_device(args))
        dim_s = handler.config.dim_s
        dim_u = handler.config.dim_u
        if args.env in ANALYTIC_MODELS:
            # The analytic reward reads fixed state slots (pendulum: cos/sin/thdot);
            # exporting a checkpoint with other dims would bake a controller that
            # silently optimizes the wrong objective — refuse up front.
            want_s = {"pendulum": 3, "cartpole": 4}[args.env]
            want_u = 1
            if (dim_s, dim_u) != (want_s, want_u):
                print(
                    f"error: checkpoint is dim_s={dim_s}, dim_u={dim_u} but the "
                    f"{args.env!r} analytic reward expects dim_s={want_s}, "
                    f"dim_u={want_u} — wrong checkpoint for this --env",
                    file=sys.stderr,
                )
                return 2
            _, reward = ANALYTIC_MODELS[args.env]
            space = _analytic_action_space(args.env)
        elif args.env == "Pendulum-v1":
            # Same mapping `learn` uses: real pendulum reward, real +/-2.0 torque bounds.
            reward = _reward_for_gym_env(args.env)
            space = _analytic_action_space("pendulum")
        else:
            reward = _reward_for_gym_env(args.env)
            if args.action_low is None or args.action_high is None:
                # The checkpoint records dims, not bounds; exporting with guessed bounds
                # would bake a controller that can only command part of the actuator
                # range (or an infeasible one) — make the user state them.
                print(
                    f"error: {args.env!r} has no built-in action bounds; pass "
                    "--action-low and --action-high (the env's action_space.low/high)",
                    file=sys.stderr,
                )
                return 2
            space = BoxSpace.of([args.action_low] * dim_u, [args.action_high] * dim_u)
    elif args.env in ANALYTIC_MODELS:
        dynamics, reward = ANALYTIC_MODELS[args.env]
        handler = DynamicsHandler(true_model=dynamics, device=_device(args))
        dim_s = {"pendulum": 3, "cartpole": 4}[args.env]
        space = _analytic_action_space(args.env)
    else:
        print(
            f"unknown analytic model {args.env!r} and no --checkpoint-dir; available: "
            f"{sorted(ANALYTIC_MODELS)}", file=sys.stderr,
        )
        return 2
    policy = MPCPolicy(
        action_space=space,
        reward_function=reward,
        dynamics_handler=handler,
        solver_name=args.solver,
        num_agents=args.num_envs,
        planning_horizon=args.planning_horizon,
        population=args.population,
        max_iterations=args.iterations,
        seed=args.seed,
        action_smoothness_weight=args.smoothness,
        device=_device(args),
        **({"time_major": True} if args.time_major else {}),
    )
    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    meta = export_policy_artifact(policy, args.output, dim_s=dim_s, platforms=platforms)
    print(json.dumps({"artifact": args.output, **meta}))
    return 0


def cmd_inspect(args):
    """Prints a .bbmpc artifact's metadata and tensor inventory without loading its
    programs (ops tooling: what is this file, what will it serve, is it for my device)."""
    import zipfile

    try:
        zf_ctx = zipfile.ZipFile(args.artifact)
    except FileNotFoundError:
        print(f"error: no such file: {args.artifact}", file=sys.stderr)
        return 2
    except zipfile.BadZipFile:
        print(
            f"error: {args.artifact} is not a .bbmpc artifact (not a zip — an "
            "export_dynamics program loads with torch.export.load instead)",
            file=sys.stderr,
        )
        return 2
    try:
        with zf_ctx as zf:
            meta = json.loads(zf.read("meta.json"))
            groups = {}
            for group in ("state", "params", "proposer", "key"):
                manifest = json.loads(zf.read(f"{group}/manifest.json"))
                groups[group] = {
                    "leaves": len(manifest),
                    "bytes": sum(
                        zf.getinfo(f"{group}/{i}.bin").file_size
                        for i in range(len(manifest))
                    ),
                }
            program_bytes = {
                name: zf.getinfo(name).file_size
                for name in zf.namelist() if name.endswith(".pt2")
            }
            if not program_bytes:
                raise KeyError("no <device>/step.pt2 program")
    except KeyError as e:
        # A valid zip that is not one of ours: zipfile raises KeyError on a missing
        # member — report which entry is absent instead of a traceback.
        print(
            f"error: {args.artifact} is not a .bbmpc artifact ({e.args[0]})",
            file=sys.stderr,
        )
        return 2
    print(json.dumps({"artifact": args.artifact, **meta, "tensors": groups,
                      "program_bytes": program_bytes}))
    return 0


def cmd_serve(args):
    """JSON-lines action server over a .bbmpc artifact.

    Protocol (one JSON object per line on stdin -> one per line on stdout):
      {"obs": [...], "t": 0, "explore": false}  -> {"action": [...], "predicted_next_obs":
                                                    [...], "predicted_reward": ...}
      {"cmd": "reset"}                          -> {"ok": true}
      {"cmd": "close"}                          -> exits 0
    A request that fails gets one ``{"error": ...}`` line and the server goes on.
    The first line is served by the artifact's programs as loaded, or, with
    ``--compiled-cache``, by their AOTInductor compilation: loaded from the cache when it
    exists and matches, compiled and written there otherwise.
    """
    import os

    import numpy as np

    from blackbox_mpc_torch.deploy.serving import ServingPolicy

    cache = args.compiled_cache
    srv = ServingPolicy.load(args.artifact, device=_device(args),
                             compiled_cache=cache if cache and os.path.exists(cache) else None)
    if cache and not srv.used_compiled_cache:
        srv.save_compiled(cache)
    print(json.dumps({"ready": True, "solver": srv.solver_name,
                      "num_agents": srv.num_agents,
                      "used_compiled_cache": srv.used_compiled_cache}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
            if req.get("cmd") == "close":
                return 0
            if req.get("cmd") == "reset":
                srv.reset()
                print(json.dumps({"ok": True}), flush=True)
                continue
            action, next_obs, reward = srv.act(
                np.asarray(req["obs"], np.float32), t=int(req.get("t", 0)),
                exploration_noise=bool(req.get("explore", False)),
            )
            print(json.dumps({
                "action": np.asarray(action).tolist(),
                "predicted_next_obs": np.asarray(next_obs).tolist(),
                "predicted_reward": np.asarray(reward).tolist(),
            }), flush=True)
        except Exception as e:  # noqa: BLE001 — per-request isolation: a malformed
            # request or a failure inside the program (a wrong shape, device OOM) yields a
            # JSON error line and never kills the server.
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
    return 0


def _analytic_action_space(env: str):
    from blackbox_mpc_torch.core.spaces import BoxSpace

    return {
        "pendulum": BoxSpace.of([-2.0], [2.0]),
        "cartpole": BoxSpace.of([-1.0], [1.0]),
    }[env]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="blackbox_mpc_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("solve", help="true-model MPC on an analytic task")
    _add_common(p)
    p.add_argument("--env", default="pendulum")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--rollouts", type=int, default=1)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("learn", help="iterative MBRL on a gymnasium env")
    _add_common(p)
    p.add_argument("--env", default="Pendulum-v1")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--initial-rollouts", type=int, default=5)
    p.add_argument("--refinements", type=int, default=3)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_learn)

    p = sub.add_parser(
        "export",
        help="AOT-export an MPC policy to a standalone .bbmpc serving artifact",
    )
    _add_common(p)
    p.add_argument("--env", default="pendulum")
    p.add_argument("--output", "-o", required=True, help="artifact path (.bbmpc)")
    p.add_argument(
        "--checkpoint-dir", default=None,
        help="DynamicsHandler checkpoint to export a learned-dynamics policy from",
    )
    p.add_argument(
        "--platforms", default=None,
        help="comma-separated device types to write a program for, e.g. cuda,cpu "
             "(default: the policy's)",
    )
    p.add_argument(
        "--action-low", type=float, default=None,
        help="action lower bound (required with --checkpoint-dir for envs without "
             "built-in bounds)",
    )
    p.add_argument(
        "--action-high", type=float, default=None,
        help="action upper bound (see --action-low)",
    )
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("inspect", help="print a .bbmpc artifact's metadata as JSON")
    p.add_argument("artifact")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "serve",
        help="serve a .bbmpc artifact: JSON-lines obs -> action over stdin/stdout",
    )
    p.add_argument("artifact", help="path to a .bbmpc artifact (see `export`)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    p.add_argument(
        "--compiled-cache", default=None,
        help="an AOTInductor cache of the artifact's programs for this device: loaded when "
             "present and matching (no compile at start), written after compiling otherwise. "
             "It holds compiled code, so only point this at trusted files",
    )
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "calibrate",
        help="variance-calibration check of a probabilistic dynamics checkpoint "
             "(E[res^2]/E[sigma^2] on the val split; ~1.0 = calibrated)",
    )
    p.add_argument("checkpoint_dir",
                   help="DynamicsHandler.save dir, or an MBRL-loop dir with handler/")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("solvers", help="list solvers and their config defaults")
    p.set_defaults(fn=cmd_solvers)

    args = parser.parse_args(argv)
    if hasattr(args, "cpu") and not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print(f"error: {args.command} runs on cuda, which is not available here; pass "
                  "--cpu to run on the CPU", file=sys.stderr)
            return 2
    try:
        return args.fn(args)
    except (KeyError, TypeError, ValueError, NotImplementedError) as e:
        # Configuration errors (unknown solver, bad kwargs, invalid sizes, an option not
        # ported) get one clean line instead of a traceback; real bugs still raise.
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
