"""Weight bridge: JAX ``DynamicsParams`` (as numpy) -> the port's ``DynamicsParams``.

``params`` is ``DynamicsParams.params`` of the JAX package as numpy arrays: a list of
``{"w": [E, in, out], "b": [E, out]}``, without the ``[E]`` axis when ``ensemble_size == 1``.
``stats`` holds the six ``NormalizerStats`` fields as numpy, as a mapping or as attributes.
With the same weights the port computes what the JAX package computes.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats

__all__ = ["dynamics_params_from_numpy"]


def _stat(stats, name: str):
    return stats[name] if isinstance(stats, Mapping) else getattr(stats, name)


def dynamics_params_from_numpy(
    params, stats, config: LearnedDynamicsConfig, device=None
) -> DynamicsParams:
    device = resolve_device(device)
    mlp = config.mlp
    sizes = [mlp.in_dim, *mlp.hidden, mlp.out_dim]
    if len(params) != len(sizes) - 1:
        raise ValueError(f"expected {len(sizes) - 1} layers, got {len(params)}")
    layers = []
    for i, layer in enumerate(params):
        w = np.array(layer["w"], np.float32)  # a copy: JAX arrays are read-only
        b = np.array(layer["b"], np.float32)
        if config.ensemble_size == 1 and w.ndim == 2:
            w, b = w[None], b[None]
        want = (config.ensemble_size, sizes[i], sizes[i + 1])
        if w.shape != want or b.shape != (want[0], want[2]):
            raise ValueError(
                f"layer {i}: got w {w.shape}, b {b.shape}; expected w {want}, "
                f"b {(want[0], want[2])}"
            )
        layers.append({
            "w": torch.as_tensor(w, device=device), "b": torch.as_tensor(b, device=device),
        })
    stat_tensors = NormalizerStats(*(
        torch.as_tensor(np.array(_stat(stats, f), np.float32), device=device)
        for f in STATS_FIELDS
    ))
    return DynamicsParams(params=layers, stats=stat_tensors)
