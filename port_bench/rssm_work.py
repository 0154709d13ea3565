"""The model work of the RSSM cell's ``act()``, counted from the configuration's shapes: the
matrix products of DreamerV3's RSSM (``configs/dreamerv3_200m.json``), whichever path computes
them. RMSNorms, activations, the gates' arithmetic, the softmaxes, the codes' draws and the
decode are left out: at these widths they are under 0.2 % of the operations.
"""
from __future__ import annotations

import math

__all__ = ["layer_shapes", "row_step_macs", "filter_macs", "act_flops"]


def _stack(first: int, width: int, layers: int, out: int | None = None) -> list:
    shapes = [(first if i == 0 else width, width) for i in range(layers)]
    return shapes if out is None else shapes + [(width, out)]


def layer_shapes(config: dict) -> dict:
    """``{head: [weight shape]}`` of the configuration file's ``model``, in the program's
    layout (``blackbox_mpc_torch/models/rssm.py``): ``(in, out)``, and ``(blocks, in, out)``
    for the core's block-diagonal layers."""
    m = config["model"]
    g, hid, units = m["blocks"], m["hidden"], m["units"]
    k, codes = m["deter"] // g, m["stoch"] * m["classes"]
    return {
        "encoder": _stack(m["obs_dim"], units, m["enc_layers"]),
        "core_in": [(m["deter"], hid), (codes, hid), (m["action_dim"], hid)],
        "core_hidden": [(g, k + 3 * hid if i == 0 else k, k) for i in range(m["dyn_layers"])],
        "core_gru": [(g, k, 3 * k)],
        "prior": _stack(m["deter"], hid, m["img_layers"], codes),
        "posterior": _stack(m["deter"] + units, hid, m["obs_layers"], codes),
        "reward": _stack(m["deter"] + codes, units, m["reward_layers"], m["num_bins"]),
    }


def _macs(config: dict) -> dict:
    """Multiply-adds per row of each head (a weight's elements: each is one multiply-add a
    row)."""
    return {head: sum(math.prod(s) for s in shapes)
            for head, shapes in layer_shapes(config).items()}


def row_step_macs(config: dict) -> dict:
    """One imagined step of one row: ``{"core_in", "core_blocks", "prior", "reward"}``."""
    h = _macs(config)
    return {"core_in": h["core_in"], "core_blocks": h["core_hidden"] + h["core_gru"],
            "prior": h["prior"], "reward": h["reward"]}


def filter_macs(config: dict) -> int:
    """One row's filter step: the core, the encoder and the posterior."""
    h = _macs(config)
    return h["core_in"] + h["core_hidden"] + h["core_gru"] + h["encoder"] + h["posterior"]


def act_flops(config: dict, traffic: dict) -> float:
    """The model FLOPs of one ``act()``: every candidate's H imagined steps over every agent and
    iteration, plus each agent's filter step and one-step prediction (a step's core, prior and
    reward at the returned action)."""
    kw = traffic["solver_kwargs"]
    agents = traffic["agents"]
    step = sum(row_step_macs(config).values())
    rows = kw["population"] * agents * traffic["planning_horizon"] * kw["max_iterations"]
    return 2.0 * (step * rows + agents * (filter_macs(config) + step))
