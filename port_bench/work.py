"""The work a cell asks for, counted from its shapes, and the card's published peaks.

The counts are of the work the algorithm needs, whichever kernel or eager path does it, so a
later change to the program leaves this yardstick where it is. The peaks and the functions
marked "frozen" are copies of ``chip_smoke.py`` at commit
ac03e766bab09bd63f85a82fabe5130dff9fd456 (``H100_PEAK``, ``H100_BYTES_PER_S``,
``mlp_work``, ``least_ms``, ``bound``), changed only to read plain shapes instead of the
program's config object, and, in ``mlp_work``, to take the head's width (the probabilistic
head predicts a mean and a log-variance per state dimension).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "H100_BYTES_PER_S", "H100_PEAK", "ITEMSIZE", "Shapes", "act_flops", "bound", "least_ms",
    "mlp_work", "rollout_least_ms_per_act", "shapes_of", "train_flops_per_step",
]

# Frozen: dense FLOP/s of one H100 SXM at 700 W (NVIDIA's data sheet), f32 outside the tensor
# cores, and its HBM rate.
H100_PEAK = {"float32": 67e12, "bfloat16": 989e12}
H100_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Shapes:
    dim_s: int
    dim_u: int
    hidden: tuple
    ensemble_size: int
    out_dim: int
    compute_dtype: str  # "float32" or "bfloat16"


def shapes_of(config: dict) -> Shapes:
    """The shapes of a configuration file's ``model``."""
    m = config["model"]
    out = m["dim_s"] * (2 if m.get("probabilistic", False) else 1)
    return Shapes(m["dim_s"], m["dim_u"], tuple(m["hidden"]), m["ensemble_size"], out,
                  config["compute_dtype"])


def mlp_work(shapes: Shapes, rows: int, horizon: int, members: int) -> tuple[float, float]:
    """Frozen. (FLOPs of the MLP over all rows and steps, bytes of its weights, biases and
    stats)."""
    sizes = [shapes.dim_s + shapes.dim_u, *shapes.hidden, shapes.out_dim]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    itemsize = ITEMSIZE[shapes.compute_dtype]
    weight_bytes = (shapes.ensemble_size * (macs * itemsize + 4 * sum(sizes[1:]))
                    + 4 * 6 * max(shapes.dim_s, shapes.dim_u))
    return 2.0 * macs * members * rows * horizon, weight_bytes


def least_ms(flops: float, bytes_moved: float, dtype: str) -> tuple[float, str]:
    """Frozen. Least time on the card: max(bytes moved / HBM rate, operations / peak), in
    ms."""
    t_ops = flops / H100_PEAK[dtype] * 1e3
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(shapes: Shapes, rows: int, horizon: int, members: int) -> tuple[float, str]:
    """Frozen. The rollout (K2): actions and s0 in, weights in, states out; the MLP's
    FLOPs."""
    flops, weight_bytes = mlp_work(shapes, rows, horizon, members)
    bytes_moved = (4 * horizon * rows * shapes.dim_u + 4 * rows * shapes.dim_s + weight_bytes
                   + 4 * horizon * rows * shapes.dim_s)
    return least_ms(flops, bytes_moved, shapes.compute_dtype)


def _planning(config: dict, traffic: dict) -> tuple[int, int, int, int]:
    """(rolled-out rows per iteration, members each row runs, horizon, iterations) of one
    ``act()``: every member on every row for mean propagation; one member per row, and each
    candidate rolled out once per particle, for ts1/ts_inf."""
    m = config["model"]
    kw = traffic["solver_kwargs"]
    particles = m.get("num_particles", 1) if m["propagation"] in ("ts_inf", "mm") else 1
    rows = kw["population"] * particles * traffic["agents"]
    members = m["ensemble_size"] if m["propagation"] in ("mean", "mm") else 1
    return rows, members, traffic["planning_horizon"], kw.get("max_iterations", 1)


def act_flops(config: dict, traffic: dict) -> float:
    """The model FLOPs of one ``act()``: the MLP forward over every rolled-out row, member,
    step and iteration (the one-step lookahead, one row per agent, is left out)."""
    rows, members, horizon, iters = _planning(config, traffic)
    return mlp_work(shapes_of(config), rows, horizon, members)[0] * iters


def rollout_least_ms_per_act(config: dict, traffic: dict) -> float:
    """The least time of one ``act()``'s rollouts on the card: the rollout's bound at the
    act's rows, once per iteration."""
    rows, members, horizon, iters = _planning(config, traffic)
    return bound(shapes_of(config), rows, horizon, members)[0] * iters


def train_flops_per_step(config: dict, batch_size: int) -> float:
    """Forward and backward FLOPs of one optimizer step (backward counted as twice the
    forward): every member on its own minibatch of ``batch_size`` rows."""
    shapes = shapes_of(config)
    forward = mlp_work(shapes, batch_size, 1, shapes.ensemble_size)[0]
    return 3.0 * forward
