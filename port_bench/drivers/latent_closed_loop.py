"""Closed-loop planning through a latent world model (TD-MPC2's): one controller calls
``MPCPolicy.act`` and starts its next call when the action of the last has reached the host,
as ``closed_loop.py`` drives the MLP ensembles, whose loop, stream and checks this driver
shares.

Set-up draws the model's weights on the device from the seed (:func:`make_weights`), builds
the program's ``LatentWorldModel`` over them and the policy with the model's decoded reward,
and warms up with ``warmup_acts`` calls (the first evaluation of the candidates' shape runs
eagerly and captures the CUDA graph that the later ones replay). The window, its timing and the
end-to-end numbers are ``closed_loop.py``'s (:func:`drive` follows its ``drive`` step by step).

``correct``: as ``closed_loop.py`` sets it out, with ``port_bench/reference/latent.py`` as the
reference: it encodes the call's observation itself, plans from the call's solver state with
the program's draws (the planner's generator and the noise generator the value draws from),
and predicts the next latent and the decoded reward at the returned action. ``answer`` holds
the action, the carried mean and that prediction to it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import latent_work, streams, trace, work
from port_bench.core import Check, Run
from port_bench.drivers.closed_loop import (_failed, _gaps, _Loop, _outcome_gaps, _sample,
                                            _start_gap)
from port_bench.program import Outcome
from port_bench.reference import CONTROL_PRECISION, precision
from port_bench.reference import latent as reference
from port_bench.reference.planning import shift
from port_bench.stats import percentile

__all__ = ["drive", "make_weights", "make_stats", "model_config"]

HEADS = ("encoder", "dynamics", "reward", "pi", "q")


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's parameters in the program's layout (``models/latent.py``), by the
    configuration's ``weights``: every Linear's weight one slice of a single normal draw on
    ``device``, times ``std`` and clipped at +/-``truncation``; zero biases; LayerNorm at
    scale 1 and shift 0 on every layer but the last of the reward, ``pi`` and Q heads; the
    task row uniform in +/-``task_row``. The Q heads' tensors lead with ``[num_q]``."""
    m, spec = config["model"], config["weights"]
    if spec["init"] != "trunc_normal":
        raise ValueError(f"unknown weights.init {spec['init']!r}")
    sizes = latent_work.layer_sizes(config)
    lead = {head: ((m["num_q"],) if head == "q" else ()) for head in HEADS}
    shapes = [(head, i, (*lead[head], a, b)) for head in HEADS
              for i, (a, b) in enumerate(zip(sizes[head][:-1], sizes[head][1:]))]
    total = sum(int(np.prod(s)) for _, _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(streams.sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(spec["std"]).clamp_(-spec["truncation"], spec["truncation"])
    params, start = {head: [] for head in HEADS}, 0
    for head, i, shape in shapes:
        n = int(np.prod(shape))
        layer = {"w": flat[start:start + n].view(shape),
                 "b": torch.zeros(shape[:-2] + shape[-1:], device=device)}
        start += n
        if i < len(sizes[head]) - 2 or head in ("encoder", "dynamics"):
            layer["ln_w"] = torch.ones_like(layer["b"])
            layer["ln_b"] = torch.zeros_like(layer["b"])
        params[head].append(layer)
    if m["task_dim"]:
        u = torch.rand(m["task_dim"], generator=gen, device=device)
        params["task"] = (2.0 * u - 1.0) * spec["task_row"]
    return params


def make_stats(config: dict, seed: int) -> dict:
    """The observation stream's per-dimension mean and std (``streams.ObservationStream``'s
    ``mean_states``/``std_states``), numpy float32, from the configuration's laws."""
    rng = np.random.default_rng(streams.sub_seed(seed, "stats"))
    n = config["model"]["obs_dim"]
    out = {}
    for name, field in (("mean", "mean_states"), ("std", "std_states")):
        law, a, b = config["observations"][name]
        draw = rng.normal(a, b, n) if law == "normal" else rng.uniform(a, b, n)
        out[field] = draw.astype(np.float32)
    return out


def model_config(config: dict):
    """The program's ``LatentModelConfig`` of a configuration file (the model computes in
    float32)."""
    from blackbox_mpc_torch.models.latent import LatentModelConfig

    if config["compute_dtype"] != "float32":
        raise ValueError(f"the latent model computes in float32, not {config['compute_dtype']}")
    return LatentModelConfig(**{k: v for k, v in config["model"].items() if k != "dropout"})


def _build(run: Run):
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models.latent import LatentWorldModel

    config, traffic = run.config, run.traffic
    run.mark("program_imported")
    weights = make_weights(config, run.seed, run.device)
    stats = make_stats(config, run.seed)
    run.mark("weights_made")  # the first CUDA work: the context starts here
    model = LatentWorldModel(model_config(config), device=run.device, params=weights)
    run.mark("handler_built")
    low, high = config["action_bounds"]
    policy_seed = streams.sub_seed(run.seed, "policy")
    policy = MPCPolicy(
        BoxSpace.of(low, high, dim=config["model"]["action_dim"]), model.reward_fn, model,
        solver_name=traffic["solver"], num_agents=traffic["agents"],
        planning_horizon=traffic["planning_horizon"], discount=traffic["discount"],
        seed=policy_seed, device=run.device, rollout_backend=traffic["rollout_backend"],
        **traffic["solver_kwargs"])
    return weights, stats, model, policy, policy_seed


def drive(run: Run) -> Outcome:
    cuda = run.device != "cpu"
    config, traffic = run.config, run.traffic
    run.mark("driver_started")
    weights, stats, model, policy, policy_seed = _build(run)
    run.mark("built")
    loop = _Loop(run, policy, stats)
    loop.act()
    run.mark("first_call")  # the first evaluation captured its graph
    for _ in range(traffic["warmup_acts"] - 1):
        loop.act()
    first = loop.records[0]
    loop.restart()
    if cuda:
        torch.cuda.synchronize()
    run.settle()

    traced = None
    if run.trace:
        traced = trace.profile_window(
            loop.act, lambda: [loop.act() for _ in range(traffic["trace_acts"])], cuda)
        records = loop.records[1:]  # the profiler's warm-up call is not in the window
        window_s = traced.window_s
    else:
        deadline = time.perf_counter() + run.seconds
        opened = time.perf_counter()
        while time.perf_counter() < deadline:
            loop.act()
        window_s = time.perf_counter() - opened
        records = loop.records
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    low, high = (float(x) for x in config["action_bounds"])
    ms = [r["ms"] for r in records]
    run.extra["deciles"] = [percentile(ms, q) for q in range(0, 101, 10)]
    end_to_end = {"act_ms_p50": percentile(ms, 50), "act_ms_p95": percentile(ms, 95),
                  "agent_plans_per_s": len(records) * traffic["agents"] / window_s}
    work_counts = {"acts": len(records), "agents": traffic["agents"], "window_s": window_s,
                   "flops_per_act": latent_work.act_flops(config, traffic),
                   "peak_flops": work.H100_PEAK[config["compute_dtype"]]}
    del loop, policy, model  # the program's state is freed before the reference runs
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = _compare(run, weights, stats, first, records, policy_seed)
    return Outcome(len(records), _failed(records, low, high), end_to_end, checks, peak,
                   traced, work_counts, readings)


def _plan(run: Run, model, rec, kind: str, tie: float = reference.TIE, target=None):
    """The reference in precision ``kind`` from the call's start: (its outcomes, each
    (action, final mean), and its prediction at the returned action: next latent, reward), as
    ``closed_loop._plan`` takes them."""
    obs = torch.as_tensor(rec["obs"], device=run.device)
    state = rec["state"]
    accept = None
    if target is not None:
        close = run.limits["answer"] / 2.0

        def accept(action, final):
            return max(_outcome_gaps(run, target, action, final).values()) <= close

    with precision(kind):
        z0 = model.encode(obs)
        outcomes = reference.plan_step(model, run.config, run.traffic, z0, state.mean,
                                       state.variance, rec["gen"], rec["noise"], tie, accept)
        ns, r = reference.lookahead(model, z0,
                                    torch.as_tensor(rec["action"], device=run.device))
    return outcomes, ns, r


def _compare(run: Run, weights, stats, first, records, policy_seed):
    """``start`` and ``answer``, as ``closed_loop._compare`` reads them; with
    ``run.extra["control"]`` the control's readings too."""
    model = reference.Model(run.config, weights, run.device)
    parts, control = {}, {}
    for i in _sample(run, records):
        rec = records[i]
        got = {k: rec[k] for k in ("action", "next_obs", "reward")}
        got["after"] = rec["after"].mean
        want = _plan(run, model, rec, "float32", target=got)
        for name, gap in _gaps(run, got, want).items():
            parts[name] = max(parts.get(name, 0.0), gap)
        if run.extra.get("control"):
            (outcome,), ns, r = _plan(run, model, rec,
                                      CONTROL_PRECISION[run.config["compute_dtype"]], tie=0.0)
            as_program = {"action": outcome[0], "next_obs": ns, "reward": r,
                          "after": shift(outcome[1])}
            want_control = _plan(run, model, rec, "float32", target=as_program)
            for name, gap in _gaps(run, as_program, want_control).items():
                control[name] = max(control.get(name, 0.0), gap)
    run.extra["answer_parts"] = parts
    if control:
        control["answer"] = max(control.values())
    return ({"start": Check(_start_gap(run, first, policy_seed), run.limits["start"]),
             "answer": Check(max(parts.values()), run.limits["answer"])},
            {"control_" + k: v for k, v in control.items()})
