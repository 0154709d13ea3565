"""Weight bridge between the JAX package's ``DynamicsParams`` (as numpy) and the port's.

``params`` is ``DynamicsParams.params`` of the JAX package as numpy arrays: a list of
``{"w": [E, in, out], "b": [E, out]}``, without the ``[E]`` axis when ``ensemble_size == 1``;
with learned logvar bounds the mapping ``{"net": <that list>, "lv_min": [S], "lv_max": [S]}``,
read by key. ``stats`` holds the six ``NormalizerStats`` fields as numpy, as a mapping or as
attributes. With the same weights the port computes what the JAX package computes.

:func:`handler_from_numpy` carries a whole training checkpoint of the JAX package over: the
config, params, Adam state, step, stats and replay, as JAX's ``DynamicsHandler.load`` returns
them converted to numpy, or as :func:`~blackbox_mpc_torch.learning.orbax_read.restore_pytree`
reads them from its Orbax checkpoint (``DynamicsHandler.load`` does so).

:func:`proposer_from_numpy` carries the JAX package's ``PolicyProposer.state_dict()`` (as
numpy) into the port's ``PolicyProposer``: the params and optax's Adam state. A loop
checkpoint of before Orbax holds that dict pickled in ``proposer.npy``; :func:`load_legacy_npy`
reads it without optax.

:func:`handler_to_numpy` and :func:`proposer_to_numpy` go the other way: a port handler's
``config.json`` and training state, and a port proposer's state, as the JAX package saves them
(numpy on the host, in its dtypes and shapes), for
:func:`~blackbox_mpc_torch.learning.orbax_write.save_pytree`.
"""
from __future__ import annotations

from collections.abc import Mapping

import collections
import pickle

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats

__all__ = ["dynamics_params_from_numpy", "handler_from_numpy", "handler_to_numpy",
           "load_legacy_npy", "proposer_from_numpy", "proposer_to_numpy"]


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


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _adam_state(optimizer, tensors: list) -> tuple:
    """``(count, mu, nu)`` of a ``torch.optim.Adam`` over ``tensors``, mu and nu as numpy in
    that order; zeros before the first step, as optax's fresh state."""
    states = [optimizer.state.get(t, {}) for t in tensors]
    if not any(states):
        return 0, [np.zeros(t.shape, np.float32) for t in tensors], [
            np.zeros(t.shape, np.float32) for t in tensors]
    return (int(states[0]["step"]), [_host(s["exp_avg"]) for s in states],
            [_host(s["exp_avg_sq"]) for s in states])


def _params_to_numpy(flat: list, config: LearnedDynamicsConfig):
    """Numpy leaves in :func:`~blackbox_mpc_torch.learning.trainer.flat_params` order -> the
    JAX package's params pytree: the ``[E]`` axis dropped for a one-member ensemble, the
    learned bounds in their dict."""
    squeeze = config.ensemble_size == 1
    n = len(config.mlp.hidden) + 1
    layers = [{k: v[0] if squeeze else v for k, v in (("w", flat[2 * i]), ("b", flat[2 * i + 1]))}
              for i in range(n)]
    if len(flat) == 2 * n:
        return layers
    return {"net": layers, "lv_min": flat[2 * n], "lv_max": flat[2 * n + 1]}


def handler_to_numpy(handler) -> tuple:
    """``(meta, tree)``: a learned port handler as the JAX package's ``DynamicsHandler.save``
    writes it. ``meta`` is ``config.json``'s dict; ``tree`` the Orbax pytree: ``params``,
    ``opt_state`` as optax's ``adam`` restores (``[{count, mu, nu}, None]``, ``count`` int32),
    ``step`` (int32), ``stats`` and ``replay`` (its ``state_dict``, RNG included), all host
    numpy."""
    from blackbox_mpc_torch.learning.handler import CHECKPOINT_FORMAT_VERSION, config_to_json
    from blackbox_mpc_torch.learning.trainer import flat_params

    if handler.is_true_model:
        raise RuntimeError("true-model handler has nothing to save")
    config, ts = handler.config, handler.train_state
    tensors = flat_params(ts.params)
    count, mu, nu = _adam_state(ts.optimizer, tensors)
    replay = handler.replay.state_dict()
    meta = {"format_version": CHECKPOINT_FORMAT_VERSION, "replay_keys": sorted(replay),
            "config": config_to_json(config), "train_calls": handler._train_calls,
            "stats_fitted": handler._stats_fitted}
    tree = {"params": _params_to_numpy([_host(t) for t in tensors], config),
            "opt_state": [{"count": np.asarray(count, np.int32),
                           "mu": _params_to_numpy(mu, config),
                           "nu": _params_to_numpy(nu, config)}, None],
            "step": np.asarray(ts.step, np.int32),
            "stats": {f: _host(getattr(handler.dynamics_params.stats, f)) for f in STATS_FIELDS},
            "replay": replay}
    return meta, tree


def proposer_from_numpy(state, config, bounds, device=None):
    """A port ``PolicyProposer`` holding the JAX proposer's ``state_dict()``: ``params`` a list
    of ``{"w": [in, out], "b": [out]}`` (shapes checked against ``config``), ``opt_state``
    optax's ``adam`` state (``count`` -> ``step``, ``mu``/``nu`` -> ``exp_avg``/``exp_avg_sq``,
    matched by layer and key), as optax's tuples or as mappings."""
    from blackbox_mpc_torch.learning.proposer import PolicyProposer

    proposer = PolicyProposer(config, bounds, device=device)

    def layers(tree):
        return [{k: np.array(layer[k], np.float32)[None] for k in ("w", "b")} for layer in tree]

    opt_state = state["opt_state"]
    moments = {name: [layer[k] for layer in layers(_adam_field(opt_state, name))
                      for k in ("w", "b")] for name in ("mu", "nu")}
    proposer.load_state_dict({
        "params": layers(state["params"]),
        "adam": {"step": int(np.asarray(_adam_field(opt_state, "count"))),
                 "exp_avg": moments["mu"], "exp_avg_sq": moments["nu"]},
    })
    return proposer


def proposer_to_numpy(proposer) -> dict:
    """A port ``PolicyProposer``'s state as the JAX package's ``state_dict()`` (host numpy):
    ``params`` a list of ``{"w": [in, out], "b": [out]}`` and ``opt_state`` optax's ``adam``
    state ``[{count, mu, nu}, None]`` (``step`` -> ``count`` int32, ``exp_avg``/``exp_avg_sq``
    -> ``mu``/``nu``)."""
    state = proposer.state_dict()

    def layers(flat):
        return [{"w": _host(w)[0], "b": _host(b)[0]} for w, b in zip(flat[0::2], flat[1::2])]

    adam = state["adam"]
    return {"params": layers([layer[k] for layer in state["params"] for k in ("w", "b")]),
            "opt_state": [{"count": np.asarray(adam["step"], np.int32),
                           "mu": layers(adam["exp_avg"]), "nu": layers(adam["exp_avg_sq"])},
                          None]}


# The optax containers a pickled proposer state holds, by class name: their fields.
_OPTAX_STATES = {"ScaleByAdamState": ("count", "mu", "nu"), "EmptyState": ()}


class _LegacyUnpickler(pickle.Unpickler):
    """Unpickles numpy and builtins as they are, and optax's state tuples as namedtuples of
    the same fields, so no optax is needed; any other class is refused."""

    def find_class(self, module, name):
        if module.split(".")[0] == "optax" and name in _OPTAX_STATES:
            return collections.namedtuple(name, _OPTAX_STATES[name])
        if module.split(".")[0] in ("numpy", "builtins", "copyreg", "_codecs"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def load_legacy_npy(path: str):
    """The object stored in a one-element pickled object array (``np.save`` of
    ``np.asarray([obj], dtype=object)``), read without optax."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read_header is None:
            raise ValueError(f"{path}: .npy format version {version} is not read here")
        shape, _, dtype = read_header(f)
        if dtype != np.dtype(object) or shape != (1,):
            raise ValueError(f"{path}: expected a pickled object array of one element, "
                             f"got {dtype} {shape}")
        return _LegacyUnpickler(f).load()[0]
