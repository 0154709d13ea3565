"""MLP dynamics model, with ensembles as a stacked leading parameter axis.

Counterpart of ``blackbox_mpc_tpu/models/mlp.py``. Parameters are a list of
``{"w": [E, in, out], "b": [E, out]}`` dictionaries of tensors; the ensemble forward is one
batched matmul over ``[E]`` per layer.

Cast order (``mlp.py:58-71``): the input is cast to ``compute_dtype``; each matmul
accumulates in float32 and adds a float32 bias; a hidden activation is applied and then cast
to ``compute_dtype``; the head returns float32. Operands in ``compute_dtype`` are upcast to
float32 before the matmul: a product of two bfloat16 values is exact in float32, so this is a
bfloat16 matmul with float32 accumulation, as ``preferred_element_type=float32`` asks.

:func:`normed_linear` is a layer of another kind, which the latent world model
(``models/latent.py``) stacks: a Linear, then a LayerNorm, then an activation (TD-MPC2's
``NormedLinear``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "ACTIVATIONS", "MLPConfig", "mlp_apply", "mlp_init", "ensemble_init", "ensemble_apply",
    "ensemble_forward", "round_to", "LAYER_NORM_EPS", "linear", "normed_linear",
]

ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    # x * tanh(softplus(x)): the hidden activation of TD-MPC2's layers.
    "mish": F.mish,
}
# torch.nn.LayerNorm's default.
LAYER_NORM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    out_dim: int
    hidden: Sequence[int] = (32, 32, 32)
    activation: str = "tanh"
    compute_dtype: torch.dtype = torch.float32


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held as float32 (identity for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _layer_init(generator: torch.Generator, fan_in: int, fan_out: int, lead=()):
    """Glorot-uniform weights and zero bias (Keras ``Dense`` default)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((*lead, fan_in, fan_out), generator=generator, device=generator.device)
    return {
        "w": (2.0 * u - 1.0) * limit,
        "b": torch.zeros((*lead, fan_out), device=generator.device),
    }


def ensemble_init(generator: torch.Generator, config: MLPConfig, num_members: int):
    """Stacked-params ensemble: every tensor has a leading ``[E]`` axis."""
    sizes = [config.in_dim, *config.hidden, config.out_dim]
    return [
        _layer_init(generator, sizes[i], sizes[i + 1], lead=(num_members,))
        for i in range(len(sizes) - 1)
    ]


def mlp_init(generator: torch.Generator, config: MLPConfig):
    """One network, as a one-member ensemble (the port always keeps the ``[E]`` axis)."""
    return ensemble_init(generator, config, 1)


def ensemble_forward(layers, x: torch.Tensor, activation: str, compute_dtype) -> torch.Tensor:
    """``layers``: list of ``(w [E,in,out], b [E,out])``; ``x``: ``[B, in]`` (shared by every
    member) or ``[E, B, in]`` (one batch per member). Returns ``[E, B, out]`` float32."""
    act = ACTIVATIONS[activation]
    ensemble = layers[0][0].shape[0]
    h = round_to(x.float(), compute_dtype)
    if h.dim() == 2:
        h = h.expand(ensemble, *h.shape)
    for i, (w, b) in enumerate(layers):
        h = torch.baddbmm(b.float()[:, None, :], h, round_to(w.float(), compute_dtype))
        if i < len(layers) - 1:
            h = round_to(act(h), compute_dtype)
    return h


def _pairs(params):
    return [(layer["w"], layer["b"]) for layer in params]


def ensemble_apply(params, x: torch.Tensor, *, config: MLPConfig) -> torch.Tensor:
    """Every member on ``x``: ``[B, in]`` (or ``[E, B, in]``) -> ``[E, B, out]``."""
    return ensemble_forward(_pairs(params), x, config.activation, config.compute_dtype)


def mlp_apply(params, x: torch.Tensor, *, config: MLPConfig) -> torch.Tensor:
    """Forward of a one-member ensemble: ``[B, in] -> [B, out]``."""
    return ensemble_apply(params, x, config=config)[0]


def linear(x: torch.Tensor, layer) -> torch.Tensor:
    """``x @ w + b`` in float32. ``layer``: ``{"w": [in, out], "b": [out]}``, or a stack of
    ``n`` such layers (``w`` [n, in, out], ``b`` [n, out]) that meets ``x`` [B, in] (every
    layer on the same rows) or [n, B, in] and gives [n, B, out]."""
    w, b, x = layer["w"].float(), layer["b"].float(), x.float()
    if w.dim() == 2:
        return torch.addmm(b, x, w)
    if x.dim() == 2:
        x = x.expand(w.shape[0], *x.shape)
    return torch.baddbmm(b[:, None, :], x, w)


def normed_linear(x: torch.Tensor, layer, activation: str | None = "mish") -> torch.Tensor:
    """``activation(LayerNorm(x @ w + b))`` over the last axis (eps ``LAYER_NORM_EPS``, scale
    ``ln_w`` and shift ``ln_b`` [out], or [n, out] for a stack); ``activation=None`` stops after
    the LayerNorm. ``layer`` and the stacking as :func:`linear`; float32 out."""
    h = linear(x, layer)
    if h.dim() == 2:
        h = F.layer_norm(h, h.shape[-1:], layer["ln_w"], layer["ln_b"], LAYER_NORM_EPS)
    else:
        h = (F.layer_norm(h, h.shape[-1:], eps=LAYER_NORM_EPS) * layer["ln_w"][:, None, :]
             + layer["ln_b"][:, None, :])
    return h if activation is None else ACTIVATIONS[activation](h)
