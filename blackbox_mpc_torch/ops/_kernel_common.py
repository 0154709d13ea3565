"""The per-step chain shared by the rollout kernel and its plain version.

Counterpart of ``blackbox_mpc_tpu/ops/_kernel_common.py``. ``build_step_fn`` is the plain
PyTorch form of K1 (``build_step_fn``, ``_kernel_common.py:60-112``): normalize -> E-member MLP
-> mean over members (or one member per row for ts1 and ts_inf) -> the Gaussian head's sample
(ts_inf) -> denormalize -> delta. The reward is not part of the chain here: the CUDA kernel
writes the visited states and the caller applies its torch ``reward_fn`` to them (see
``ops/rollout_kernel.py``).
"""
from __future__ import annotations

import torch

from blackbox_mpc_torch.models.dynamics import (
    DynamicsParams, LearnedDynamicsConfig, bound_logvar, net_layers,
)
from blackbox_mpc_torch.models.mlp import ensemble_forward

__all__ = [
    "KERNEL_ACTIVATIONS", "build_step_fn", "check_kernel_support", "round_up", "stats_matrix",
    "weight_operands",
]

_EPS = 1e-7  # must match models/normalizer.py

# Activation ids as the CUDA kernels number them (ops/csrc/mlp_step.cuh, activate()); swish
# runs in the rollout kernel's (K2's) ts_inf instantiation only.
KERNEL_ACTIVATIONS = {"tanh": 0, "relu": 1, "gelu": 2, "swish": 3}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def check_kernel_support(config: LearnedDynamicsConfig, what: str, rollout: bool = False) -> None:
    """Raises unless the kernels named ``what`` run ``config``. ``rollout``: the rollout kernel
    (K2), which beyond the fused kernels (K4, K5) runs ts_inf, PETS' sampled propagation on a
    probabilistic head, in float32, and with it swish layers."""
    ts_inf = rollout and config.propagation == "ts_inf"
    if ts_inf:
        if config.compute_dtype != torch.float32:
            raise ValueError(f"{what} runs propagation='ts_inf' in float32 only")
    else:
        allowed = ("mean", "ts1")
        if config.ensemble_size > 1 and config.propagation not in allowed:
            raise ValueError(f"{what} supports propagation in {allowed} (or ensemble_size=1)")
        if config.probabilistic:
            raise ValueError(f"{what} supports deterministic heads only (probabilistic=False)")
    if config.activation not in KERNEL_ACTIVATIONS or (config.activation == "swish"
                                                      and not ts_inf):
        raise ValueError(f"unsupported activation for {what}: {config.activation}")
    if config.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} supports compute_dtype float32 or bfloat16")


def build_step_fn(config: LearnedDynamicsConfig, stats: torch.Tensor, weights, grouped=False,
                  lv_bounds: torch.Tensor | None = None):
    """Returns ``step(s, a, noise=None) -> next_state``.

    ``stats`` is the ``[6, max(S,U)]`` matrix of :func:`stats_matrix`; ``weights`` the
    per-layer ``(w, b)`` list of :func:`weight_operands`. With ``grouped=False`` the rows
    ``s [T,S]``, ``a [T,U]`` run every member and the next state uses the member mean; with
    ``grouped=True`` (ts1, ts_inf) ``s [E,T,S]``, ``a [E,T,U]`` hold one block of rows per
    member and block ``e`` runs member ``e`` only. A probabilistic head (``[mean S | raw
    log-variance S]``) gives its means, or with ``noise`` (shaped as ``s``) the sample
    ``mean + exp(logvar / 2) * noise``, the log-variance bounded by ``lv_bounds`` (``[2, S]``:
    lower, upper) as ``models/dynamics.py::bound_logvar`` bounds it.
    """
    dim_s, dim_u = config.dim_s, config.dim_u
    ensemble = config.ensemble_size
    mean_s, std_s = stats[0, :dim_s], stats[1, :dim_s]
    mean_a, std_a = stats[2, :dim_u], stats[3, :dim_u]
    mean_t, std_t = stats[4, :dim_s], stats[5, :dim_s]
    layers = list(zip(weights[0::2], weights[1::2]))

    def net(x):
        out = ensemble_forward(layers, x, config.activation, config.compute_dtype)
        if grouped:
            return out
        acc = out[0]
        for e in range(1, ensemble):
            acc = acc + out[e]
        return acc / ensemble

    def step(s, a, noise=None):
        if config.normalized:
            xs = (s - mean_s) / (std_s + _EPS)
            xa = (a - mean_a) / (std_a + _EPS)
        else:
            xs, xa = s, a
        raw = net(torch.cat([xs, xa], dim=-1))
        if config.probabilistic:
            mean = raw[..., :dim_s]
            if noise is None:
                raw = mean
            else:
                logvar = bound_logvar(raw[..., dim_s:2 * dim_s], lv_bounds[0], lv_bounds[1])
                raw = mean + torch.exp(0.5 * logvar) * noise
        if config.normalized:
            raw = raw * (std_t + _EPS) + mean_t
        return s + raw if config.predict_delta else raw

    return step


def stats_matrix(dp: DynamicsParams, dim_s: int, dim_u: int) -> torch.Tensor:
    """Packs the normalizer stats into the ``[6, max(S,U)]`` float32 kernel layout."""
    width = max(dim_s, dim_u)
    st = dp.stats
    rows = [
        st.mean_states, st.std_states, st.mean_actions, st.std_actions, st.mean_targets,
        st.std_targets,
    ]
    return torch.stack(
        [torch.nn.functional.pad(v.float(), (0, width - v.shape[0])) for v in rows]
    )


def weight_operands(dp: DynamicsParams, compute_dtype) -> list:
    """Per-layer ``w`` (compute dtype, ``[E, in, out]``) and ``b`` (float32, ``[E, out]``)."""
    out = []
    for layer in net_layers(dp.params):
        out.append(layer["w"].to(compute_dtype))
        out.append(layer["b"].float())
    return out
