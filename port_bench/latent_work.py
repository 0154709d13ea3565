"""The model work of the latent cell's ``act()``, counted from the configuration's shapes: the
matrix products of TD-MPC2's heads (``configs/tdmpc2_317m.json``), whichever path computes
them. The LayerNorms, activations, SimNorm and decodes are left out: at these widths they are
under 0.1 % of the operations.
"""
from __future__ import annotations

__all__ = ["layer_sizes", "head_macs", "macs_per_row", "act_flops"]


def layer_sizes(config: dict) -> dict:
    """``{head: [in, hidden..., out]}`` of the configuration file's ``model``; the heads read
    ``[z, task, a]`` (``pi`` ``[z, task]``, the encoder ``[obs, task]``)."""
    m = config["model"]
    z, t, a, w = m["latent_dim"], m["task_dim"], m["action_dim"], m["mlp_dim"]
    enc = [m["obs_dim"] + t, *[m["enc_dim"]] * max(m["num_enc_layers"] - 1, 1), z]
    return {"encoder": enc, "dynamics": [z + t + a, w, w, z],
            "reward": [z + t + a, w, w, m["num_bins"]], "pi": [z + t, w, w, 2 * a],
            "q": [z + t + a, w, w, m["num_bins"]]}


def head_macs(config: dict) -> dict:
    """Multiply-adds per row of each head: ``{"encoder", "dynamics", "reward", "pi", "q"}``
    (one Q head)."""
    return {head: sum(i * o for i, o in zip(s[:-1], s[1:]))
            for head, s in layer_sizes(config).items()}


def macs_per_row(config: dict, horizon: int) -> int:
    """One candidate's evaluation: ``horizon`` steps of the dynamics and the reward, then the
    value, ``pi`` and two Q heads."""
    h = head_macs(config)
    return horizon * (h["dynamics"] + h["reward"]) + h["pi"] + 2 * h["q"]


def act_flops(config: dict, traffic: dict) -> float:
    """The model FLOPs of one ``act()``'s solve: every candidate of every agent and iteration
    (the encoder and the one-step lookahead, a row per agent each, left out)."""
    kw = traffic["solver_kwargs"]
    rows = kw["population"] * traffic["agents"]
    return 2.0 * macs_per_row(config, traffic["planning_horizon"]) * rows * kw["max_iterations"]
