"""Dynamics training: ``DynamicsHandler.train(epochs, batch_size)`` calls back to back on a
replay made in set-up.

Set-up makes the weights on the device from the seed, builds the handler, fills its replay
with the mix's rollouts (made from the seed) and runs ``warmup_calls`` calls; the first fits
the normalizer, as ``train()`` does once (on every row: the configuration holds nothing
out, as PETS trains on all it has). The window then calls ``train()`` until
``--seconds`` have passed; each call is timed on the host clock (it ends by reading its
losses on the host). With ``--trace 1`` the window is ``trace_calls`` calls under the
profiler.

``correct``: during the first call of set-up the harness keeps, for the first three optimizer
steps, the minibatch each step was fed, the members' losses it returned, the parameters
before the first step, the optimizer's first moment after the first step (Adam's is
``(1 - beta1) g``: the first gradient as the optimizer got it) and the parameters after the
third step. Once the window has closed, the peak read and the program freed, the reference
takes the same three steps from the run's weights on the same minibatches and the numbers
below are held to ``limits/<workload>.json``:

* ``start``: the parameters before the first step against the run's weights (exact);
* ``feed``: minibatch rows that are no row of the replay, rows repeated within a member's
  three batches, and batches of another shape than ``[E, batch_size]`` (a count, 0);
* ``loss``: the widest gap of a member's loss in a step, relative to the larger of that
  loss and the median member's;
* ``grad``: the widest gap between the norms of a leaf's first gradient, relative to the
  larger of the reference's norm of that leaf and of the median leaf;
* ``update``: the same for the change of each leaf over the three steps, leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench import program, streams, trace, work
from port_bench.core import Check, Run
from port_bench.program import Outcome
from port_bench.reference import CONTROL_PRECISION, precision
from port_bench.reference import training as ref
from port_bench.stats import percentile

__all__ = ["drive", "STEPS", "gaps"]

STEPS = 3  # the optimizer steps the reference follows
GRAD_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _flat(params) -> list:
    """The program's trainable tensors in the optimizer's order."""
    from blackbox_mpc_torch.learning.trainer import flat_params

    return flat_params(params)


def _recording(handler, kept: dict):
    """Wraps the handler's optimizer step to keep the first STEPS steps' inputs and
    outputs; the original is restored by the caller."""
    step = handler._train_step

    def recorded(ts, stats, s, a, ns):
        n = len(kept["batches"])
        if n < STEPS:
            if n == 0:
                kept["before"] = [p.detach().clone() for p in _flat(ts.params)]
            kept["batches"].append((s, a, ns))
        ts, losses = step(ts, stats, s, a, ns)
        if n < STEPS:
            kept["losses"].append(losses.clone())
            if n == 0:
                # An optimizer that took no step holds no moment: it reads as zero.
                state = ts.optimizer.state
                kept["first_moment"] = [
                    state[p]["exp_avg"].detach().clone() if "exp_avg" in state[p]
                    else torch.zeros_like(p) for p in _flat(ts.params)]
            if n == STEPS - 1:
                kept["after"] = [p.detach().clone() for p in _flat(ts.params)]
        return ts, losses

    return recorded


def drive(run: Run) -> Outcome:
    from blackbox_mpc_torch.models.normalizer import identity_stats

    cuda = run.device != "cpu"
    config, traffic = run.config, run.traffic
    train_cfg = config["training"]
    if train_cfg["holdout_ratio"] != 0:
        raise ValueError("the reference fits its normalizer on every row of the replay: "
                         "holdout_ratio must be 0")
    run.mark("driver_started")
    weights = streams.make_weights(config, run.seed, run.device)
    scale = streams.make_stats(config, run.seed)
    handler = program.handler(config, streams.sub_seed(run.seed, "handler"), run.device,
                              learning_rate=train_cfg["learning_rate"],
                              validation_fraction=train_cfg["holdout_ratio"])
    m = config["model"]
    handler.set_params(program.dynamics_params(
        weights, identity_stats(m["dim_s"], m["dim_u"], device=run.device)))
    replay = traffic["replay"]
    obs, actions = streams.replay_rollouts(scale, run.seed, traffic["stream_rho"],
                                           replay["episodes"], replay["steps"], m["dim_u"])
    handler.replay.add_rollouts(list(obs), list(actions))
    batch = traffic["batch_size"]
    run.mark("built")

    def call():
        t0 = time.perf_counter()
        out = handler.train(epochs=traffic["epochs"], batch_size=batch)
        return time.perf_counter() - t0, out

    kept = {"batches": [], "losses": []}
    original = handler._train_step
    handler._train_step = _recording(handler, kept)
    try:
        call()
    finally:
        handler._train_step = original
    run.mark("first_call")
    for _ in range(traffic["warmup_calls"] - 1):
        call()
    if cuda:
        torch.cuda.synchronize()
    run.settle()

    traced, calls = None, []
    if run.trace:
        traced = trace.profile_window(
            call, lambda: calls.extend(call() for _ in range(traffic["trace_calls"])), cuda)
    else:
        deadline = time.perf_counter() + run.seconds
        while time.perf_counter() < deadline:
            calls.append(call())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.extra["deciles"] = [percentile([1e3 * s for s, _ in calls], q) for q in range(0, 101, 10)]
    steps = handler.replay.num_train // batch * traffic["epochs"]
    samples = steps * batch * m["ensemble_size"]
    end_to_end = {"train_samples_per_s": samples * len(calls) / sum(s for s, _ in calls)}
    work_counts = {"train_steps": steps * len(calls),
                   "flops_per_step": work.train_flops_per_step(config, batch),
                   "peak_flops": work.H100_PEAK[config["compute_dtype"]]}
    failed = sum(1 for _, out in calls if not math.isfinite(out["train_loss"]))
    dim_s = m["dim_s"]
    train_rows = (obs[:, :-1].reshape(-1, dim_s), actions.reshape(-1, m["dim_u"]),
                  obs[:, 1:].reshape(-1, dim_s))
    del handler, original  # the program's state is freed before the reference runs
    if cuda:
        torch.cuda.empty_cache()
    values, readings = gaps(run, weights, train_rows, kept,
                            control=bool(run.extra.get("control")))
    checks = {name: Check(v, run.limits[name]) for name, v in values.items()}
    return Outcome(len(calls), failed, end_to_end, checks, peak, traced, work_counts, readings)


def _feed_faults(kept: dict, rows: tuple, batch: int) -> int:
    """Rows of the kept minibatches that are no row of ``rows`` or repeat within a member,
    and batches of another shape."""
    table = {r.tobytes() for r in np.concatenate(rows, axis=1)}
    faults = 0
    seen = None
    for s, a, ns in kept["batches"]:
        x = np.concatenate([t.detach().cpu().numpy() for t in (s, a, ns)], axis=-1)
        if x.ndim != 3 or x.shape[1] != batch:
            faults += 1
            continue
        seen = [set() for _ in range(x.shape[0])] if seen is None else seen
        for member, member_rows in enumerate(x):
            for r in member_rows:
                key = np.ascontiguousarray(r, dtype=np.float32).tobytes()
                faults += key not in table or key in seen[member]
                seen[member].add(key)
    return faults


def _norm_gap(got: list, want: list, keep=None) -> float:
    """The widest gap between leaf norms, relative to the larger of the reference's norm of
    that leaf and of the median leaf; ``keep``: the leaves counted."""
    norms = [float(torch.linalg.vector_norm(w)) for w in want]
    median = float(np.median(norms))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if keep is not None and not keep[i]:
            continue
        gap = abs(float(torch.linalg.vector_norm(g.to(w.device))) - norms[i])
        worst = max(worst, gap / max(norms[i], median))
    return worst


def _loss_gap(got, want) -> float:
    """``got``, ``want``: ``[steps, E]``."""
    got = torch.as_tensor(got, device=want.device)
    scale = torch.maximum(want.abs(), want.abs().median(dim=1, keepdim=True).values)
    return float(((got - want).abs() / scale).max())


def gaps(run: Run, weights, train_rows: tuple, kept: dict, control: bool = False):
    """The numbers of ``correct`` from what set-up kept; with ``control`` also the control's
    and the faults' readings (the reference in the precision below, and with half of each
    batch, against the reference)."""
    config = run.config
    lr = config["training"]["learning_rate"]
    beta1 = ref.BETAS[0]
    stats = ref.fit_stats(*train_rows)
    start = max(float((b.to(w.device) - w).abs().max())
                for b, w in zip(kept["before"], ref.leaves(weights)))
    values = {"start": start,
              "feed": float(_feed_faults(kept, train_rows, run.traffic["batch_size"]))}
    batches = kept["batches"]
    with precision("float32"):
        losses, grad, after = ref.adam_steps(config, weights, stats, batches, lr)
    start_leaves = ref.leaves(weights)
    change = [a - w for a, w in zip(after, start_leaves)]
    grad_norms = [float(torch.linalg.vector_norm(g)) for g in grad]
    counted = [n >= GRAD_FLOOR * float(np.median(grad_norms)) for n in grad_norms]

    def numbers(losses_got, grad_got, after_got) -> dict:
        return {"loss": _loss_gap(losses_got, losses),
                "grad": _norm_gap(grad_got, grad),
                "update": _norm_gap([a.to(w.device) - w for a, w in
                                     zip(after_got, start_leaves)], change, counted)}

    values.update(numbers(torch.stack(kept["losses"]),
                          [m / (1.0 - beta1) for m in kept["first_moment"]], kept["after"]))
    readings = {}
    if control:
        with precision(CONTROL_PRECISION[config["compute_dtype"]]):
            low = ref.adam_steps(config, weights, stats, batches, lr)
        with precision("float32"):
            half = ref.adam_steps(config, weights, stats, batches, lr, half=True)
        for name, v in numbers(*low).items():
            readings["control_" + name] = v
        for name, v in numbers(*half).items():
            readings["half_batch_" + name] = v
        readings["unchanged_update"] = numbers(losses, grad, start_leaves)["update"]
    return values, readings
