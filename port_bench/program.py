"""The program under test, built from a configuration file: the dynamics handler with the
run's weights, and the reward the configuration states. The only module of the harness that
imports the program, with the drivers (``drivers/``)."""
from __future__ import annotations

from dataclasses import dataclass, field

from port_bench.streams import Weights

__all__ = ["Outcome", "dynamics_config", "dynamics_params", "reward_fn", "handler"]


@dataclass
class Outcome:
    """What a driver hands back: the requests attempted and failed, the end-to-end numbers,
    the traced window and the work counts its readers need, the peak, and the checks."""

    attempted: int
    failed: int
    end_to_end: dict
    checks: dict
    memory_peak_bytes: int
    traced: object = None
    work: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)  # the control's, when asked for


def dynamics_config(config: dict):
    import torch

    from blackbox_mpc_torch import LearnedDynamicsConfig

    m = dict(config["model"])
    m["hidden"] = tuple(m["hidden"])
    return LearnedDynamicsConfig(**m, compute_dtype=getattr(torch, config["compute_dtype"]))


def dynamics_params(weights: Weights, stats):
    """The program's ``DynamicsParams`` over the run's weights (``stats``: a
    ``NormalizerStats``)."""
    from blackbox_mpc_torch.models.dynamics import DynamicsParams

    layers = [{"w": w, "b": b} for w, b in weights.layers]
    params = (layers if weights.lv_min is None
              else {"net": layers, "lv_min": weights.lv_min, "lv_max": weights.lv_max})
    return DynamicsParams(params=params, stats=stats)


def reward_fn(config: dict):
    """The user's reward ``(s, a, s') -> [B]``: a state's forward velocity minus a quadratic
    action cost."""
    r = config["reward"]
    index, cost = r["velocity_index"], r["action_cost"]

    def reward(s, a, ns):
        return ns[:, index] - cost * (a * a).sum(-1)

    return reward


def handler(config: dict, seed: int, device, **kwargs):
    from blackbox_mpc_torch import DynamicsHandler

    return DynamicsHandler(dynamics_config(config), seed=seed, device=device, **kwargs)
