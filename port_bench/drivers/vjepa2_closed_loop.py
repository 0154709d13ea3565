"""Closed-loop planning toward a goal image through V-JEPA 2-AC's world model: one controller
calls ``MPCPolicy.act`` on an image and a state and starts its next call when the action of the
last has reached the host, as ``closed_loop.py`` drives the MLP ensembles, whose loop and checks
this driver shares.

Set-up draws the model's weights on the device from the seed (:func:`make_weights`), builds the
program's ``VJEPA2ACWorldModel`` over them and the policy with the model's reward (none a step:
the plan's value is minus its last frame's energy to the goal), sets the first episode's goal,
and warms up with ``warmup_acts`` calls (the first evaluation of the candidates' shape runs
eagerly and captures the CUDA graph that the later ones replay). Observations and goals come
from the seed (:class:`Scenes`): smooth random images that drift from call to call, a state
that walks, and a goal image of its own for each episode, set through the model's ``set_goal``
at every reset. The window, its timing and the end-to-end numbers are ``closed_loop.py``'s
(:func:`drive` follows its ``drive`` step by step).

``correct``: as ``closed_loop.py`` sets it out, with ``port_bench/reference/vjepa2_ac.py`` as
the reference. It encodes the call's image and the episode's goal itself, plans from the call's
solver state with the program's draws, with no cache (each imagined frame from the predictor's
forward over every frame before it), and predicts the next frame at the returned action.
``answer`` holds, against the nearest outcome of the search that rounding allows, the action
(of the half range) and the chosen plan's value (its last iteration's elites' mean return,
minus their energy, which the solve reports and the driver keeps; relative to max(1,
|reference|)); against the reference's prediction the call's reported next planning row (the
predicted frame's latents and the integrated state: frame 0 alone, no cache); and, element by
element, the last frame of the call's chosen plan (its final mean, which the solve reports and
the driver keeps) rolled out after the window by the same program object through its cache
(``begin_rollout``, ``dynamics_fn``), against the reference's last frame of that plan.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench import streams, trace, vjepa2_work, work
from port_bench.core import Check, Run
from port_bench.drivers.closed_loop import _failed, _far, _Loop, _sample, _start_gap
from port_bench.program import Outcome
from port_bench.reference import CONTROL_PRECISION, precision
from port_bench.reference import vjepa2_ac as reference
from port_bench.reference.planning import SQRT2
from port_bench.stats import percentile

__all__ = ["Scenes", "drive", "make_weights", "model_config"]


def _is_matrix(name: str) -> bool:
    return not name.endswith("_b") and name not in ("ln1_w", "ln2_w", "norm_w")


def _matrix_sizes(tree: dict):
    """The element counts of ``tree``'s matrices, in the order of sorted names."""
    for name, shape in sorted(tree.items()):
        if isinstance(shape, dict):
            yield from _matrix_sizes(shape)
        elif _is_matrix(name):
            yield math.prod(shape)


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's parameters in the program's layout (``vjepa2_work.param_shapes``), by the
    configuration's ``weights``: every matrix one slice, in the order of sorted names, of a
    single uniform draw on ``device``, mapped in place by inverse CDF to a standard normal
    truncated at +/-``truncation`` and scaled by ``std``; zero biases; LayerNorm at scale 1 and
    shift 0."""
    spec = config["weights"]
    if spec["init"] != "trunc_normal":
        raise ValueError(f"unknown weights.init {spec['init']!r}")
    shapes = vjepa2_work.param_shapes(config)
    gen = torch.Generator(device=device).manual_seed(streams.sub_seed(seed, "weights"))
    flat = torch.rand(sum(_matrix_sizes(shapes)), generator=gen, device=device)
    cut = math.erf(spec["truncation"] / SQRT2)
    flat.mul_(2.0 * cut).sub_(cut).erfinv_().mul_(SQRT2)
    flat.clamp_(-spec["truncation"], spec["truncation"]).mul_(spec["std"])
    start = 0

    def walk(tree):
        nonlocal start
        out = {}
        for name, shape in sorted(tree.items()):
            if isinstance(shape, dict):
                out[name] = walk(shape)
            elif _is_matrix(name):
                n = math.prod(shape)
                out[name] = flat[start:start + n].view(shape)
                start += n
            else:
                out[name] = (torch.zeros if name.endswith("_b") else torch.ones)(
                    shape, device=device)
        return out

    return walk(shapes)


def model_config(config: dict):
    """The program's ``VJEPA2ACConfig`` of a configuration file (the model computes in
    float32)."""
    from blackbox_mpc_torch.models.vjepa2_ac import VJEPA2ACConfig

    if config["compute_dtype"] != "float32":
        raise ValueError(f"the model computes in float32, not {config['compute_dtype']}")
    return VJEPA2ACConfig(**config["model"])


class Scenes:
    """The closed loop's observations and goals, made from the seed, independent of the
    program's outputs. Image ``t``: per channel a ``coarse x coarse`` field ``x_t``, bilinearly
    upsampled to the image and put through ``sigmoid(gain * .)``, where ``x_{t+1} = rho x_t +
    sqrt(1 - rho^2) eps``; the state: ``s_0`` of std ``state_std``, then ``s_{t+1} = s_t +
    state_step * eps``. Episode ``e``'s goal: an image of the same law from a stream of its
    own. Rows are float32: the image (channels, rows, columns), then the state."""

    CHUNK = 64

    def __init__(self, config: dict, seed: int, agents: int):
        m, sc = config["model"], config["scenes"]
        self._size, self._state_dim = m["image_size"], m["state_dim"]
        self._coarse, self._gain, self._rho = sc["coarse"], sc["gain"], sc["rho"]
        self._step = sc["state_step"]
        self._rng = np.random.default_rng(streams.sub_seed(seed, "scenes"))
        self._goal_seed = streams.sub_seed(seed, "goals")
        self._x = self._rng.standard_normal((agents, 3, self._coarse, self._coarse))
        self._s = self._rng.standard_normal((agents, self._state_dim)) * sc["state_std"]
        grid = np.linspace(0.0, self._coarse - 1.0, self._size)
        low = np.minimum(np.floor(grid).astype(int), self._coarse - 2)
        frac = grid - low
        self._up = np.zeros((self._size, self._coarse))  # bilinear, corners aligned
        self._up[np.arange(self._size), low] = 1.0 - frac
        self._up[np.arange(self._size), low + 1] = frac
        self._rows: list = []

    def _image(self, x) -> np.ndarray:
        field = self._up @ x @ self._up.T
        return 1.0 / (1.0 + np.exp(-self._gain * field))

    def __call__(self, t: int) -> np.ndarray:
        """``[agents, 3 x size x size + state_dim]`` float32."""
        while t >= len(self._rows):
            for _ in range(self.CHUNK):
                image = self._image(self._x).reshape(self._x.shape[0], -1)
                self._rows.append(np.concatenate([image, self._s], axis=1).astype(np.float32))
                eps = self._rng.standard_normal(self._x.shape)
                self._x = self._rho * self._x + math.sqrt(1.0 - self._rho ** 2) * eps
                self._s = self._s + self._step * self._rng.standard_normal(self._s.shape)
        return self._rows[t]

    def goal(self, episode: int) -> np.ndarray:
        """Episode ``episode``'s goal image, ``[3 x size x size]`` float32."""
        rng = np.random.default_rng([self._goal_seed, episode])
        x = rng.standard_normal((3, self._coarse, self._coarse))
        return self._image(x).reshape(-1).astype(np.float32)


class _GoalLoop(_Loop):
    """``closed_loop.py``'s controller with a goal: each episode (the first, every
    ``reset_every`` calls, and at a restart) sets its own goal image through the model's
    ``set_goal``. Each call keeps the episode's goal, and the plan the solve chose (its final
    mean) with the value it gave it."""

    def __init__(self, run: Run, policy, model, scenes: Scenes):
        self.policy, self.model, self.stream = policy, model, scenes
        self.reset_every = run.traffic["reset_every"]
        self.index = self.step = self.episode = 0
        self.records: list = []
        self.value = self.plan = None
        solve = policy._solve

        def solve_and_keep(*args, **kwargs):
            action, state, aux = solve(*args, **kwargs)
            # On the device; read after the window.
            self.value, self.plan = aux.expected_reward, aux.plan
            return action, state, aux

        policy._solve = solve_and_keep
        self._set_goal()

    def _set_goal(self) -> None:
        self.goal = self.stream.goal(self.episode)
        self.model.set_goal(self.goal)

    def act(self) -> dict:
        if self.step == self.reset_every:
            self.policy.reset()
            self.step = 0
            self.episode += 1
            self._set_goal()
        rec = super().act()
        rec.update(goal=self.goal, value=self.value, plan=self.plan)
        return rec

    def restart(self) -> None:
        super().restart()
        self.episode += 1
        self._set_goal()


def _build(run: Run):
    from blackbox_mpc_torch import MPCPolicy
    from blackbox_mpc_torch.core.spaces import BoxSpace
    from blackbox_mpc_torch.models.vjepa2_ac import VJEPA2ACWorldModel

    config, traffic = run.config, run.traffic
    run.mark("program_imported")
    weights = make_weights(config, run.seed, run.device)
    run.mark("weights_made")  # the first CUDA work: the context starts here
    model = VJEPA2ACWorldModel(model_config(config), device=run.device, params=weights)
    run.mark("handler_built")
    low, high = config["action_bounds"]
    policy_seed = streams.sub_seed(run.seed, "policy")
    policy = MPCPolicy(
        BoxSpace.of(low, high, dim=config["model"]["action_dim"]), model.reward_fn, model,
        solver_name=traffic["solver"], num_agents=traffic["agents"],
        planning_horizon=traffic["planning_horizon"], discount=traffic["discount"],
        seed=policy_seed, device=run.device, rollout_backend=traffic["rollout_backend"],
        **traffic["solver_kwargs"])
    return weights, model, policy, policy_seed


def drive(run: Run) -> Outcome:
    cuda = run.device != "cpu"
    config, traffic = run.config, run.traffic
    run.mark("driver_started")
    weights, model, policy, policy_seed = _build(run)
    run.mark("built")
    loop = _GoalLoop(run, policy, model, Scenes(config, run.seed, traffic["agents"]))
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
                   "flops_per_act": vjepa2_work.act_flops(config, traffic),
                   "peak_flops": work.H100_PEAK[config["compute_dtype"]],
                   "kv_cache_bytes": model.kv_cache_bytes}
    for rec in records:
        rec["value"] = rec["value"].cpu().numpy()
    sampled = _sample(run, records)
    for i in sampled:
        records[i]["rollout"] = _rollout(model, records[i])
    del loop, policy, model  # the program's state is freed before the reference runs
    if cuda:
        torch.cuda.empty_cache()
    checks, readings = _compare(run, weights, first, records, sampled, policy_seed)
    return Outcome(len(records), _failed(records, low, high), end_to_end, checks, peak,
                   traced, work_counts, readings)


@torch.no_grad()
def _rollout(model, rec) -> np.ndarray:
    """The last frame's latents [A, patches x enc_dim] of the call's chosen plan, rolled out by
    the program from the call's observation through its cache of earlier frames."""
    plan = rec["plan"]
    state = model.begin_rollout(model.encode(torch.as_tensor(rec["obs"], device=plan.device)),
                                plan.shape[1])
    for k in range(plan.shape[1]):
        state = model.dynamics_fn(model.dynamics_params, state, plan[:, k])
    return state.z.flatten(1).cpu().numpy()


def _outcome_gaps(run: Run, got: dict, action, value) -> dict:
    """The gaps of ``got``'s action (of the half range of the bounds) and plan value (relative
    to max(1, |reference|)) from one outcome of the reference."""
    low, high = (float(x) for x in run.config["action_bounds"])
    return {"action": _far(got["action"], action, (high - low) / 2.0),
            "energy": _far(got["value"], value)}


def _gaps(run: Run, got: dict, want: tuple) -> dict:
    """The gaps of ``got`` from the reference's ``want`` = ``_plan(...)``: the action and the
    plan's value against the nearest of the reference's outcomes, the reported next row
    against the reference's prediction, the chosen plan's last frame against the reference's."""
    outcomes, ns, last = want
    best = min((_outcome_gaps(run, got, action, value) for action, _, value in outcomes),
               key=lambda gaps: max(gaps.values()))
    best["lookahead"] = _far(got["next_obs"], ns)
    best["rollout"] = _far(got["rollout"], last)
    return best


def _plan(run: Run, model, rec, kind: str, tie: float = reference.TIE, target=None,
          plan=None):
    """The reference in precision ``kind`` from the call's start: (its outcomes, each (action,
    final mean, plan value), its prediction of the next planning row at the returned action,
    and the last frame's latents of ``plan`` [A, H, U], by default its own first outcome's
    final mean). ``tie``: as ``planning.plan_step``; its search stops at an outcome within half
    the cell's ``answer`` limit of ``target``."""
    m = run.config["model"]
    obs = torch.as_tensor(rec["obs"], device=run.device)
    image = obs[:, :-m["state_dim"]].reshape(-1, 3, m["image_size"], m["image_size"])
    s0 = obs[:, -m["state_dim"]:]
    goal_image = torch.as_tensor(rec["goal"], device=run.device).reshape(1, *image.shape[1:])
    accept = None
    if target is not None:
        close = run.limits["answer"] / 2.0

        def accept(action, final, value):
            return max(_outcome_gaps(run, target, action, value).values()) <= close

    state = rec["state"]
    with precision(kind):
        z0 = model.encode(image)
        goal = model.encode(goal_image)[0]
        outcomes = reference.plan_step(model, run.config, run.traffic, z0, s0, goal,
                                       state.mean, state.variance, rec["gen"], tie, accept)
        ns = model.lookahead(z0, s0, torch.as_tensor(rec["action"], device=run.device))
        last = model.last_frame(z0, s0, outcomes[0][1] if plan is None else plan)
    return outcomes, ns, last.flatten(1)


def _compare(run: Run, weights, first, records, sampled, policy_seed):
    """``start`` and ``answer`` over the ``sampled`` calls, as ``closed_loop._compare`` reads
    them; with ``run.extra["control"]`` the control's readings too."""
    model = reference.Model(run.config, weights, run.device)
    parts, control = {}, {}
    for i in sampled:
        rec = records[i]
        got = {k: rec[k] for k in ("action", "next_obs", "value", "rollout")}
        want = _plan(run, model, rec, "float32", target=got, plan=rec["plan"])
        for name, gap in _gaps(run, got, want).items():
            parts[name] = max(parts.get(name, 0.0), gap)
        if run.extra.get("control"):
            # The reference in the nearest precision below, put in the program's place: its
            # own ranking, no ties followed.
            ((action, final, value),), ns, last = _plan(
                run, model, rec, CONTROL_PRECISION[run.config["compute_dtype"]], tie=0.0)
            as_program = {"action": action, "next_obs": ns, "value": value, "rollout": last}
            want_control = _plan(run, model, rec, "float32", target=as_program, plan=final)
            for name, gap in _gaps(run, as_program, want_control).items():
                control[name] = max(control.get(name, 0.0), gap)
    run.extra["answer_parts"] = parts
    if control:
        control["answer"] = max(control.values())
    return ({"start": Check(_start_gap(run, first, policy_seed), run.limits["start"]),
             "answer": Check(max(parts.values()), run.limits["answer"])},
            {"control_" + k: v for k, v in control.items()})
