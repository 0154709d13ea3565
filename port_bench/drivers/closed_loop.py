"""Closed-loop planning: one controller calls ``MPCPolicy.act`` and starts its next call when
the action of the last has reached the host.

Set-up makes the weights on the device and the normalizer's statistics from the seed, builds
the handler and the policy, and warms up with ``warmup_acts`` calls (the first builds the
kernels). The window then calls ``act()`` on the observation stream until ``--seconds`` have
passed, resetting the policy every ``reset_every`` calls (an episode); each call is timed on
the host clock. With ``--trace 1`` the window is ``trace_acts`` calls under the profiler.

``correct``: every call keeps what it started from (the solver's state and the generators'
states, a reference each, no copy) and what it returned. Once the window has closed, the
peak read and the program freed, the reference plans a sample of the calls again from those
starts (the slowest call and ``sample_acts`` drawn from the seed) and the numbers below are
held to ``limits/<workload>.json``:

* ``start``: the solver's state before the first call against the planner's initial state,
  and the planner's generator against a fresh one of the policy's seed (exact);
* ``answer``: the widest of a call's gaps from the reference, over the sampled calls: the
  returned action (as a share of the half range of the bounds), with warm start the state
  the call left against the shifted final mean, and the reported next state and reward
  against the reference's prediction at the returned action (relative to max(1,
  |reference|)). Where returns crowd at the elite boundary, rounding may let the program
  keep other elites than the reference: the reference searches the outcomes that rounding
  allows for the call's answer (``planning.plan_step``), and the action and state are held
  against the nearest outcome found. One number: on some seeds
  no call's plan moves under the control's precision, so only its prediction shows it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import program, streams, trace, work
from port_bench.core import Check, Run
from port_bench.program import Outcome
from port_bench.reference import CONTROL_PRECISION, planning, precision
from port_bench.reference.model import Model
from port_bench.stats import percentile

__all__ = ["drive"]


def _build(run: Run):
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats

    config, traffic = run.config, run.traffic
    run.mark("program_imported")
    weights = streams.make_weights(config, run.seed, run.device)
    stats = streams.make_stats(config, run.seed)
    run.mark("weights_made")  # the first CUDA work: the context starts here
    handler = program.handler(config, streams.sub_seed(run.seed, "handler"), run.device)
    handler.set_params(program.dynamics_params(weights, NormalizerStats(
        *(torch.as_tensor(stats[f], device=run.device) for f in STATS_FIELDS))))
    run.mark("handler_built")
    low, high = config["action_bounds"]
    policy_seed = streams.sub_seed(run.seed, "policy")
    policy = MPCPolicy(
        BoxSpace.of(low, high, dim=config["model"]["dim_u"]), program.reward_fn(config),
        handler, solver_name=traffic["solver"], num_agents=traffic["agents"],
        planning_horizon=traffic["planning_horizon"], seed=policy_seed, device=run.device,
        rollout_backend=traffic["rollout_backend"], **traffic["solver_kwargs"])
    return weights, stats, handler, policy, policy_seed


class _Loop:
    """The controller: the stream, the episode's step and the record of every call."""

    def __init__(self, run: Run, policy, stats):
        self.policy = policy
        self.stream = streams.ObservationStream(stats, run.seed, run.traffic["stream_rho"],
                                                run.traffic["agents"])
        self.reset_every = run.traffic["reset_every"]
        self.index = 0  # the stream's
        self.step = 0  # the episode's
        self.records: list = []

    def act(self) -> dict:
        if self.step == self.reset_every:
            self.policy.reset()
            self.step = 0
        obs = self.stream(self.index)
        p = self.policy
        rec = {"obs": obs, "state": p._solver_state, "gen": p._generator.get_state(),
               "noise": p._noise_generator.get_state()}
        t0 = time.perf_counter()
        action, next_obs, reward = p.act(obs, self.step)
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(action=action, next_obs=next_obs, reward=reward, after=p._solver_state)
        self.records.append(rec)
        self.index += 1
        self.step += 1
        return rec

    def restart(self) -> None:
        """A new episode, and only the calls from here on in the record."""
        self.policy.reset()
        self.step = 0
        self.records = []


def _failed(records, low: float, high: float) -> int:
    return sum(1 for r in records if not (np.all(np.isfinite(r["action"]))
                                          and np.all(r["action"] >= low)
                                          and np.all(r["action"] <= high)))


def drive(run: Run) -> Outcome:
    cuda = run.device != "cpu"
    config, traffic = run.config, run.traffic
    run.mark("driver_started")
    weights, stats, handler, policy, policy_seed = _build(run)
    run.mark("built")
    loop = _Loop(run, policy, stats)
    loop.act()
    run.mark("first_call")  # the kernels built or loaded
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
                   "flops_per_act": work.act_flops(config, traffic),
                   "rollout_least_ms_per_act": work.rollout_least_ms_per_act(config, traffic),
                   "peak_flops": work.H100_PEAK[config["compute_dtype"]]}
    del loop, policy, handler  # the program's state is freed before the reference runs
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = _compare(run, weights, stats, first, records, policy_seed)
    return Outcome(len(records), _failed(records, low, high), end_to_end, checks, peak,
                   traced, work_counts, readings)


def _sample(run: Run, records: list) -> list:
    """The slowest call and ``sample_acts`` others drawn from the seed."""
    slowest = max(range(len(records)), key=lambda i: records[i]["ms"])
    rest = [i for i in range(len(records)) if i != slowest]
    rng = np.random.default_rng(streams.sub_seed(run.seed, "sample"))
    n = min(run.traffic["sample_acts"], len(rest))
    return [slowest, *sorted(rng.choice(rest, size=n, replace=False).tolist())]


def _plan(run: Run, model, rec, kind: str, tie: float = planning.TIE, target=None):
    """The reference in precision ``kind`` from the call's start: (its outcomes, each
    (action, final mean or None), and its prediction at the returned action: next state,
    reward). ``tie``: as ``planning.plan_step``; its search stops at an outcome within half
    the cell's ``answer`` limit of ``target`` (an answer as ``_gaps`` takes it)."""
    obs = torch.as_tensor(rec["obs"], device=run.device)
    state = rec["state"]
    cem = run.traffic["solver"] == "CEM"
    accept = None
    if target is not None:
        close = run.limits["answer"] / 2.0

        def accept(action, final):
            return max(_outcome_gaps(run, target, action, final).values()) <= close

    with precision(kind):
        outcomes = planning.plan_step(
            model, run.config, run.traffic, obs, state.mean if cem else None,
            state.variance if cem else None, rec["gen"], rec["noise"], tie, accept)
        ns, r = planning.lookahead(model, run.config, obs,
                                   torch.as_tensor(rec["action"], device=run.device))
    return outcomes, ns, r


def _far(x, ref, scale=None) -> float:
    x = torch.as_tensor(x, device=ref.device, dtype=ref.dtype)
    return float((x - ref).abs().max()) / (scale or max(1.0, float(ref.abs().max())))


def _outcome_gaps(run: Run, got: dict, action, final) -> dict:
    """The gaps of ``got``'s action and, with warm start, of the state it left from one
    outcome of the reference, as shares of the half range of the bounds."""
    low, high = (float(x) for x in run.config["action_bounds"])
    half = (high - low) / 2.0
    gaps = {"action": _far(got["action"], action, half)}
    if final is not None and run.traffic["solver_kwargs"].get("warm_start", False):
        gaps["carry"] = _far(got["after"], planning.shift(final), half)
    return gaps


def _gaps(run: Run, got: dict, want: tuple) -> dict:
    """The gaps of ``got`` (action, the state it left, next state, reward) from the
    reference's ``want`` = ``_plan(...)``: the action and the carried state against the
    nearest of the reference's outcomes."""
    outcomes, ns, r = want
    best = min((_outcome_gaps(run, got, action, final) for action, final in outcomes),
               key=lambda gaps: max(gaps.values()))
    best["lookahead"] = max(_far(got["next_obs"], ns), _far(got["reward"], r))
    return best


def _start_gap(run: Run, first: dict, policy_seed: int) -> float:
    """The state before the first call against the planner's documented start (the
    midpoint of the bounds, variance (range / 4)^2), and the planner's generator against a
    fresh one of the policy's seed."""
    fresh = torch.Generator(device=run.device)
    fresh.manual_seed(policy_seed)
    gap = 0.0 if torch.equal(first["gen"], fresh.get_state()) else float("inf")
    if run.traffic["solver"] == "CEM":
        low, high = (float(x) for x in run.config["action_bounds"])
        state = first["state"]
        gap = max(gap, float((state.mean - (low + high) / 2.0).abs().max()),
                  float((state.variance - (high - low) ** 2 / 16.0).abs().max()))
    return gap


def _compare(run: Run, weights, stats, first, records, policy_seed):
    """``start`` and ``answer``: the widest gap, over the sampled calls, of any part of a
    call's answer (its action, the state it left, its reported next state and reward) from
    the reference's. The parts' own widest gaps go to ``run.extra["answer_parts"]``; with
    ``run.extra["control"]`` the control's are returned too."""
    model = Model(run.config, weights, stats, run.device)
    parts, control = {}, {}
    for i in _sample(run, records):
        rec = records[i]
        got = {k: rec[k] for k in ("action", "next_obs", "reward")}
        got["after"] = rec["after"].mean if hasattr(rec["after"], "mean") else None
        want = _plan(run, model, rec, "float32", target=got)
        for name, gap in _gaps(run, got, want).items():
            parts[name] = max(parts.get(name, 0.0), gap)
        if run.extra.get("control"):
            # The reference in the nearest precision below, put in the program's place: its
            # own ranking, no ties followed.
            (outcome,), ns, r = _plan(run, model, rec,
                                      CONTROL_PRECISION[run.config["compute_dtype"]], tie=0.0)
            as_program = {"action": outcome[0], "next_obs": ns, "reward": r,
                          "after": None if outcome[1] is None else planning.shift(outcome[1])}
            # Judged as the program is: the search looks for the control's answer.
            want_control = _plan(run, model, rec, "float32", target=as_program)
            for name, gap in _gaps(run, as_program, want_control).items():
                control[name] = max(control.get(name, 0.0), gap)
    run.extra["answer_parts"] = parts
    if control:
        control["answer"] = max(control.values())
    return ({"start": Check(_start_gap(run, first, policy_seed), run.limits["start"]),
             "answer": Check(max(parts.values()), run.limits["answer"])},
            {"control_" + k: v for k, v in control.items()})
