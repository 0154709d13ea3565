"""Closed-loop planning through a recurrent world model (DreamerV3's RSSM) by PlaNet's CEM: one
controller calls ``MPCPolicy.act`` and starts its next call when the action of the last has
reached the host, as ``closed_loop.py`` drives the MLP ensembles, whose loop, stream and checks
this driver shares. Each call also keeps the belief the policy carried into it and the one it
left, beside its solver state.

Set-up draws the model's weights on the device from the seed (:func:`make_weights`), builds the
program's ``RSSMWorldModel`` over them and the policy with the model's decoded reward, and warms
up with ``warmup_acts`` calls (the first evaluation of the candidates' shape runs eagerly and
captures the CUDA graph that the later ones replay). The window, its timing and the end-to-end
numbers are ``closed_loop.py``'s (:func:`drive` follows its ``drive`` step by step).

``correct``: as ``closed_loop.py`` sets it out, with ``port_bench/reference/rssm.py`` as the
reference. After the window, a second policy over the program's model, whose evaluations run
eagerly (``remat_rollout``: no CUDA graph, so every imagined step runs through the model's
step, which replays the graph's kernels in their order), plans each sampled call again from
its starts and records, per evaluation, its candidates, the classes it drew and its returns.
The reference filters the call's observation from the carried belief with the program's
posterior draw, plans from the call's solver state with the program's draws, taking the
program's classes at ties (``reference/rssm.py``), and predicts the next feature and the
reward at the returned action. The checks:

* ``start``: ``closed_loop.py``'s, and the first call's belief DreamerV3's zeros (exact);
* ``answer``: the widest gap, over the sampled calls, of the action (of the half range of the
  bounds), the prediction (next feature and reward, relative to max(1, |reference|)), the
  carried belief (``h`` and the action kept, against the reference's filter and the returned
  action) and the re-run's action against the window's;
* ``ties``: the most ties at which the program's class differs from the reference's, over the
  sampled calls, in one call (filter and followed evaluations);
* ``picks``: the picks outside the tie margin at which the two differ, over the sampled calls.
"""
from __future__ import annotations

import math
import time

import torch

from port_bench import rssm_work, streams, trace, work
from port_bench.core import Check, Run
from port_bench.drivers.closed_loop import _failed, _far, _gaps, _Loop, _outcome_gaps, _sample
from port_bench.drivers.closed_loop import _start_gap
from port_bench.drivers.latent_closed_loop import make_stats
from port_bench.program import Outcome
from port_bench.reference import CONTROL_PRECISION, precision
from port_bench.reference import rssm as reference
from port_bench.reference.planning import ERF_HI, ERF_LO, SQRT2
from port_bench.stats import percentile

__all__ = ["drive", "make_weights", "model_config"]

# The standard deviation of a standard normal cut at +/-2.
TRUNCATED_STD = 0.87962566103423978


def _normed(head: str, index: int, layers: int) -> bool:
    """Whether layer ``index`` of ``head`` (of ``layers``) has an RMSNorm scale: every hidden
    layer; a head's last Linear and the GRU's gates have none."""
    if head == "core_gru":
        return False
    return head in ("encoder", "core_in", "core_hidden") or index < layers - 1


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's parameters in the program's layout (``models/rssm.py``), by the
    configuration's ``weights``: every weight one slice of a single uniform draw on ``device``,
    mapped by inverse CDF to a standard normal truncated at +/-``truncation`` and scaled to a
    variance of 1 / fan_in (fan_in the layer's whole input: ``rssm_work.layer_shapes`` less its
    last axis); zero biases; RMSNorm scales of 1 (a block layer's over all its groups' units)."""
    spec = config["weights"]
    if spec["init"] != "trunc_normal_fan_in" or spec["truncation"] != 2.0:
        raise ValueError(f"unknown weights {spec!r}")
    shapes = rssm_work.layer_shapes(config)
    total = sum(math.prod(s) for layers in shapes.values() for s in layers)
    gen = torch.Generator(device=device).manual_seed(streams.sub_seed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device)
    flat = torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * flat), -2.0, 2.0)
    params, start = {}, 0
    for head, layers in shapes.items():
        params[head] = []
        for i, shape in enumerate(layers):
            n = math.prod(shape)
            w = flat[start:start + n].mul_(1.0 / math.sqrt(math.prod(shape[:-1]))
                                           / TRUNCATED_STD).view(shape)
            start += n
            layer = {"w": w, "b": torch.zeros(shape[:-2] + shape[-1:], device=device)}
            if _normed(head, i, len(layers)):
                layer["scale"] = torch.ones(math.prod(shape[:-2]) * shape[-1], device=device)
            params[head].append(layer)
    return params


def model_config(config: dict):
    """The program's ``RSSMConfig`` of a configuration file (the model computes in float32)."""
    from blackbox_mpc_torch.models.rssm import RSSMConfig

    if config["compute_dtype"] != "float32":
        raise ValueError(f"the RSSM computes in float32, not {config['compute_dtype']}")
    return RSSMConfig(**config["model"])


def _policy(run: Run, model, policy_seed: int, **kwargs):
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace

    config, traffic = run.config, run.traffic
    low, high = config["action_bounds"]
    return MPCPolicy(
        BoxSpace.of(low, high, dim=config["model"]["action_dim"]), model.reward_fn, model,
        solver_name=traffic["solver"], num_agents=traffic["agents"],
        planning_horizon=traffic["planning_horizon"], discount=traffic["discount"],
        seed=policy_seed, device=run.device, **traffic["solver_kwargs"], **kwargs)


def _build(run: Run):
    from blackbox_mpc_torch.models.rssm import RSSMWorldModel

    run.mark("program_imported")
    weights = make_weights(run.config, run.seed, run.device)
    stats = make_stats(run.config, run.seed)
    run.mark("weights_made")  # the first CUDA work: the context starts here
    model = RSSMWorldModel(model_config(run.config), device=run.device, params=weights)
    run.mark("handler_built")
    policy_seed = streams.sub_seed(run.seed, "policy")
    policy = _policy(run, model, policy_seed, rollout_backend=run.traffic["rollout_backend"])
    return weights, stats, model, policy, policy_seed


class _BeliefLoop(_Loop):
    """``closed_loop.py``'s controller, each call's record holding the belief the policy
    carried into it (``belief``) and the one it left (``belief_after``)."""

    def act(self) -> dict:
        if self.step == self.reset_every:
            self.policy.reset()
            self.step = 0
        belief = self.policy.belief
        rec = super().act()
        rec["belief"], rec["belief_after"] = belief, self.policy.belief
        return rec


def drive(run: Run) -> Outcome:
    cuda = run.device != "cpu"
    config, traffic = run.config, run.traffic
    run.mark("driver_started")
    weights, stats, model, policy, policy_seed = _build(run)
    run.mark("built")
    loop = _BeliefLoop(run, policy, stats)
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
                   "flops_per_act": rssm_work.act_flops(config, traffic),
                   "peak_flops": work.H100_PEAK[config["compute_dtype"]]}
    del loop, policy  # the window's graphs are freed; the model's weights stay for the re-run
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = _compare(run, weights, model, first, records, policy_seed)
    return Outcome(len(records), _failed(records, low, high), end_to_end, checks, peak,
                   traced, work_counts, readings)


def _rerun(run: Run, model, policy_seed: int):
    """``rerun(rec) -> (evaluations, action)``: the call of ``rec`` planned again from its
    starts by a policy over the program's model whose evaluations stay eager, each evaluation
    ``(candidates [H, rows, U], classes [H, rows, stoch] as uint8, returns [rows])`` as the
    program's own step drew and summed them."""
    from blackbox_mpc_torch.models import rssm

    cfg = model.config
    steps = []

    class Recording(rssm.RSSMWorldModel):
        def dynamics_fn(self, params, feat, a, noise=None):
            out = super().dynamics_fn(params, feat, a, noise)
            if noise is not None:
                codes = out[:, cfg.deter:].reshape(out.shape[0], cfg.stoch, cfg.classes)
                steps.append((a, codes.argmax(-1).to(torch.uint8),
                              rssm.reward(cfg, params, out)))
            return out

    recording = Recording(cfg, device=model.device, params=model.dynamics_params)
    # remat_rollout: no CUDA graph, so the program's step runs (and records) at every
    # evaluation; under act()'s no_grad it recomputes nothing.
    policy = _policy(run, recording, policy_seed, rollout_backend="eager", remat_rollout=True)
    horizon = run.traffic["planning_horizon"]

    def rerun(rec):
        steps.clear()
        policy._solver_state, policy._belief = rec["state"], rec["belief"]
        policy._generator.set_state(rec["gen"])
        policy._noise_generator.set_state(rec["noise"])
        action, _, _ = policy.act(rec["obs"])
        evaluations = []
        for i in range(0, len(steps), horizon):
            a, c, r = zip(*steps[i:i + horizon])
            total = torch.zeros_like(r[0])
            for x in r:  # in the evaluator's order: total + 1.0 * r_t
                total = total + x
            evaluations.append((torch.stack(a), torch.stack(c), total))
        return evaluations, action

    return rerun


def _plan(run: Run, model, rec, kind: str, program=None, tie: float = reference.TIE,
          target=None):
    """The reference in precision ``kind`` from the call's start: ``(outcomes, next feature,
    reward, filtered feature, counts, evaluations)``. ``program``: the program's answer
    (``belief_after`` and ``evaluations``, whose classes are taken at ties); None takes the
    reference's own classes everywhere (the control). ``tie`` and ``target``: as
    ``closed_loop._plan``."""
    cfg = run.config["model"]
    kw = run.traffic["solver_kwargs"]
    obs = torch.as_tensor(rec["obs"], device=run.device)
    agents = obs.shape[0]
    u_filter, u = reference.code_uniforms(
        rec["noise"], agents, kw["population"] * agents, run.traffic["planning_horizon"],
        cfg["stoch"], run.device)
    accept = None
    if target is not None:
        close = run.limits["answer"] / 2.0

        def accept(action, final):
            return max(_outcome_gaps(run, target, action, final).values()) <= close

    theirs = None
    if program is not None:
        codes = program["belief_after"].feat[:, cfg["deter"]:]
        theirs = codes.reshape(agents, cfg["stoch"], cfg["classes"]).argmax(-1)
    state = rec["state"]
    with precision(kind):
        feat, counts = reference.observe(model, rec["belief"].feat, rec["belief"].action, obs,
                                         u_filter, theirs)
        outcomes, plan_counts, evaluations = reference.plan_step(
            model, run.config, run.traffic, feat, state.mean, state.variance, rec["gen"], u,
            None if program is None else program["evaluations"], tie, accept)
        ns, r = reference.lookahead(model, feat,
                                    torch.as_tensor(rec["action"], device=run.device))
    counts = {**plan_counts, "ties": counts["ties"] + plan_counts["ties"],
              "picks": counts["picks"] + plan_counts["picks"],
              "tie_gap": max(counts["tie_gap"], plan_counts["tie_gap"])}
    return outcomes, ns, r, feat, counts, evaluations


def _belief_gap(run: Run, got: dict, feat) -> float:
    """The carried ``h`` against the reference's filter (of max(1, |reference|)) and the kept
    action against the returned one (exact)."""
    deter = run.config["model"]["deter"]
    after = got["belief_after"]
    kept = torch.as_tensor(got["action"], device=after.action.device).reshape(after.action.shape)
    exact = 0.0 if torch.equal(after.action.float(), kept.float()) else math.inf
    return max(_far(after.feat[:, :deter], feat[:, :deter]), exact)


def _judge(run: Run, model, rec, got: dict) -> tuple:
    """``(gaps, counts)`` of ``got`` (an answer in the program's form) against the float32
    reference that takes its classes at ties."""
    outcomes, ns, r, feat, counts, _ = _plan(run, model, rec, "float32", program=got,
                                             target=got)
    gaps = _gaps(run, got, (outcomes, ns, r))
    gaps["belief"] = _belief_gap(run, got, feat)
    return gaps, counts


def _compare(run: Run, weights, program_model, first, records, policy_seed):
    """``start``, ``answer``, ``ties`` and ``picks`` (the module's notes); with
    ``run.extra["control"]`` the control's readings too: the reference in TF32 with its own
    classes everywhere, put in the program's place and judged as it is."""
    from blackbox_mpc_torch.models.rssm import Belief

    model = reference.Model(run.config, weights, run.device)
    rerun = _rerun(run, program_model, policy_seed)
    parts, control = {}, {}
    counts = {"ties": 0, "picks": 0}
    readings = {"tie_gap": 0.0, "return_gap": 0.0, "followed": math.inf}
    for i in _sample(run, records):
        rec = records[i]
        evaluations, action = rerun(rec)
        got = {k: rec[k] for k in ("action", "next_obs", "reward", "belief_after")}
        got.update(after=None, evaluations=evaluations)
        gaps, c = _judge(run, model, rec, got)
        gaps["rerun"] = _far(action, torch.as_tensor(rec["action"], device=run.device), 1.0)
        for name, gap in gaps.items():
            parts[name] = max(parts.get(name, 0.0), gap)
        counts = {"ties": max(counts["ties"], c["ties"]), "picks": counts["picks"] + c["picks"]}
        readings = {"tie_gap": max(readings["tie_gap"], c["tie_gap"]),
                    "return_gap": max(readings["return_gap"], c["return_gap"]),
                    "followed": min(readings["followed"], c["followed"])}
        if run.extra.get("control"):
            kind = CONTROL_PRECISION[run.config["compute_dtype"]]
            (outcome,), ns, r, feat, _, evals = _plan(run, model, rec, kind, tie=0.0)
            as_program = {"action": outcome[0], "next_obs": ns, "reward": r, "after": None,
                          "belief_after": Belief(feat, outcome[0]), "evaluations": evals}
            gaps, c = _judge(run, model, rec, as_program)
            for name, gap in {**gaps, "ties": c["ties"], "picks": c["picks"]}.items():
                control[name] = max(control.get(name, 0.0), gap)
    run.extra["answer_parts"] = {**parts, **counts, **readings}
    if control:
        control["answer"] = max(v for k, v in control.items() if k not in ("ties", "picks"))
    start = max(_start_gap(run, first, policy_seed),
                float(first["belief"].feat.abs().max()), float(first["belief"].action.abs().max()))
    return ({"start": Check(start, run.limits["start"]),
             "answer": Check(max(parts.values()), run.limits["answer"]),
             "ties": Check(float(counts["ties"]), run.limits["ties"]),
             "picks": Check(float(counts["picks"]), run.limits["picks"])},
            {"control_" + k: v for k, v in control.items()})
