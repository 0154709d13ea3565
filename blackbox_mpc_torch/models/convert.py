"""Weight bridge: JAX ``DynamicsParams`` (as numpy) -> the port's ``DynamicsParams``.

``params`` is ``DynamicsParams.params`` of the JAX package as numpy arrays: a list of
``{"w": [E, in, out], "b": [E, out]}``, without the ``[E]`` axis when ``ensemble_size == 1``;
with learned logvar bounds the mapping ``{"net": <that list>, "lv_min": [S], "lv_max": [S]}``,
read by key. ``stats`` holds the six ``NormalizerStats`` fields as numpy, as a mapping or as
attributes. With the same weights the port computes what the JAX package computes.

:func:`handler_from_numpy` carries a whole training checkpoint of the JAX package over: the
config, params, Adam state, step, stats and replay, as JAX's ``DynamicsHandler.load`` returns
them converted to numpy (Orbax is read where JAX is, not here).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats

__all__ = ["dynamics_params_from_numpy", "handler_from_numpy"]


def _stat(stats, name: str):
    return stats[name] if isinstance(stats, Mapping) else getattr(stats, name)


def _layers_from_numpy(params, config: LearnedDynamicsConfig, device) -> list:
    """A layer list of numpy ``{"w", "b"}`` -> tensors with the ``[E]`` axis, shapes checked."""
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
    return layers


def _params_from_numpy(params, config: LearnedDynamicsConfig, device):
    """``params`` (or an Adam moment of the same pytree) in the port's layout."""
    layers = _layers_from_numpy(params["net"] if isinstance(params, Mapping) else params,
                                config, device)
    if not (config.probabilistic and config.learn_logvar_bounds):
        return layers
    bounds = {}
    for name in ("lv_min", "lv_max"):
        v = np.array(params[name], np.float32)
        if v.shape != (config.dim_s,):
            raise ValueError(f"{name}: got shape {v.shape}, expected {(config.dim_s,)}")
        bounds[name] = torch.as_tensor(v, device=device)
    return {"net": layers, **bounds}


def dynamics_params_from_numpy(
    params, stats, config: LearnedDynamicsConfig, device=None
) -> DynamicsParams:
    device = resolve_device(device)
    stat_tensors = NormalizerStats(*(
        torch.as_tensor(np.array(_stat(stats, f), np.float32), device=device)
        for f in STATS_FIELDS
    ))
    return DynamicsParams(params=_params_from_numpy(params, config, device), stats=stat_tensors)


def _adam_field(opt_state, name: str):
    """``mu``/``nu``/``count`` of a mapping, of optax's ``ScaleByAdamState`` or of the state
    tuple of ``optax.adam`` (whose first element is that state)."""
    if isinstance(opt_state, Mapping):
        return opt_state[name]
    if name in getattr(opt_state, "_fields", ()):
        return getattr(opt_state, name)
    return _adam_field(opt_state[0], name)


def handler_from_numpy(meta: dict, params, opt_state, step, stats, replay: dict, device=None,
                       **handler_kwargs):
    """A port ``DynamicsHandler`` holding a JAX training checkpoint.

    ``meta`` is the dict of the checkpoint's ``config.json``; ``params`` and ``stats`` as in
    :func:`dynamics_params_from_numpy`; ``opt_state`` the Adam state (``mu`` -> ``exp_avg``,
    ``nu`` -> ``exp_avg_sq``, ``count`` -> ``step``), as a mapping or as optax's state, its
    moments in the layout of ``params`` (matched by key: a JAX dict pytree flattens in
    sorted key order, which is not the optimizer's);
    ``step`` the trainer's step; ``replay`` the replay's ``state_dict``. ``handler_kwargs``
    go to the constructor (``learning_rate``, ``seed``, ...). Training continues as the JAX
    handler's would.
    """
    from blackbox_mpc_torch.learning.handler import DynamicsHandler, config_from_json
    from blackbox_mpc_torch.learning.trainer import flat_params

    config = config_from_json(meta["config"])
    handler = DynamicsHandler(config=config, device=device, **handler_kwargs)
    dp = dynamics_params_from_numpy(params, stats, config, device=handler.device)
    handler._restore(dp.params, dp.stats, replay, meta)
    count = float(np.asarray(_adam_field(opt_state, "count")))
    moments = [_params_from_numpy(_adam_field(opt_state, name), config, handler.device)
               for name in ("mu", "nu")]
    optimizer = handler.train_state.optimizer
    optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(count), "exp_avg": m, "exp_avg_sq": v}
                  for i, (m, v) in enumerate(zip(flat_params(moments[0]),
                                                 flat_params(moments[1])))},
        "param_groups": optimizer.state_dict()["param_groups"],
    })
    handler.train_state.step = int(np.asarray(step))
    return handler
