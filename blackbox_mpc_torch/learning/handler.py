"""DynamicsHandler: owns the dynamics model the MPC policy plans through, its replay buffer,
its normalizer and its training.

Counterpart of ``blackbox_mpc_tpu/learning/handler.py``. A learned handler keeps two copies of
the weights: the trainable ones inside the trainer's :class:`TrainState`, which Adam updates in
place, and the planning ``DynamicsParams`` (:attr:`dynamics_params`), tensors without grad that
``train()`` replaces by a new object when it ends. The kernel backends repack their weights
when that object changes (``ops/rollout_kernel.py::operand_cache``), so the next ``act()``
plans on the new weights. A probabilistic handler also reports the heads' variance
calibration after each ``train()`` (:mod:`~blackbox_mpc_torch.learning.calibration`).

Checkpoints are the JAX package's: :meth:`save` writes ``config.json`` (version stamp, replay
keys, the config with ``compute_dtype`` by name, the counters) and the Orbax pytree
``checkpoint/`` (params, optax's Adam state, step, stats, the replay with its RNG state) through
:func:`~blackbox_mpc_torch.models.convert.handler_to_numpy` and
:func:`~blackbox_mpc_torch.learning.orbax_write.save_pytree`, so the JAX package's
``DynamicsHandler.load`` reads what the port saves. :meth:`load` reads such a directory, the
port's or the JAX package's, with :func:`~blackbox_mpc_torch.learning.orbax_read.restore_pytree`
and :func:`~blackbox_mpc_torch.models.convert.handler_from_numpy`; none of them needs JAX or
Orbax. A ``checkpoint.pt`` (a ``torch.save`` payload that earlier versions of the port wrote)
still loads, and a save over it removes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.learning.calibration import calibration_summary
from blackbox_mpc_torch.learning.replay import ReplayBuffer
from blackbox_mpc_torch.learning.trainer import flat_params, make_trainer
from blackbox_mpc_torch.models.dynamics import (
    DynamicsParams,
    LearnedDynamicsConfig,
    logvar_bounds,
    make_learned_dynamics,
    make_penalized_dynamics,
    map_params,
    net_layers,
    true_model_dynamics,
)
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats, fit_normalizer

logger = logging.getLogger(__name__)

__all__ = ["CHECKPOINT_FORMAT_VERSION", "DynamicsHandler", "config_from_json", "config_to_json"]

# The JAX package's training-checkpoint stamp: 1 adds the replay-key manifest.
CHECKPOINT_FORMAT_VERSION = 1
_PAYLOAD = "checkpoint.pt"  # written by earlier versions of the port; read, never written
_ORBAX_TREE = "checkpoint"  # the JAX package's Orbax pytree beside config.json


def config_to_json(config: LearnedDynamicsConfig) -> dict:
    """The config as ``config.json`` holds it: every field, ``compute_dtype`` by name."""
    cfg = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    cfg["hidden"] = list(cfg["hidden"])
    cfg["compute_dtype"] = str(config.compute_dtype).removeprefix("torch.")
    return cfg


def config_from_json(cfg: dict) -> LearnedDynamicsConfig:
    cfg = dict(cfg)
    cfg["hidden"] = tuple(cfg["hidden"])
    cfg["compute_dtype"] = getattr(torch, cfg["compute_dtype"])
    return LearnedDynamicsConfig(**cfg)


def _planning_copy(params):
    """Tensors without grad that no optimizer step touches, in the layout of ``params``."""
    return map_params(lambda v: v.detach().clone(), params)


class DynamicsHandler:
    """Owns dynamics params, replay and training for learned models, or wraps a true model."""

    def __init__(
        self,
        config: Optional[LearnedDynamicsConfig] = None,
        true_model: Optional[Callable] = None,
        learning_rate: float = 1e-3,
        validation_fraction: float = 0.2,
        refit_normalizer: bool = False,
        replay_max_size: Optional[int] = None,
        metrics_writer=None,
        save_dir: Optional[str] = None,
        save_frequency: int = 1,
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        """Exactly one of ``config`` (learned) / ``true_model`` (a torch
        ``(state [B,S], action [B,U]) -> next_state`` function) must be given. Learned
        weights start as a Glorot init drawn from ``seed``; the replay's split and minibatch
        orders draw from ``default_rng(seed)``, as in the JAX package.

        ``refit_normalizer=False`` fits the normalizer at the first ``train()`` only; ``True``
        fits it again at every call. ``save_dir`` checkpoints every ``save_frequency``
        ``train()`` calls. ``mesh`` (a :class:`~blackbox_mpc_torch.parallel.mesh.PopMesh`)
        trains data-parallel over its ranks (``learning/trainer.py``) on the mesh's device
        (``device`` may be None or that device): every rank holds the same replay, fits the
        same normalizer and draws the same epoch order, and reads the global losses.
        """
        if (config is None) == (true_model is None):
            raise ValueError("provide exactly one of config= or true_model=")
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r}, but this rank's device of the mesh is "
                                 f"{mesh.device}")
            device = mesh.device
        self._device = resolve_device(device)
        self._writer = metrics_writer
        self._save_dir = save_dir
        self._save_frequency = save_frequency
        self._train_calls = 0
        self._stats_fitted = False
        self._refit_normalizer = refit_normalizer
        if true_model is not None:
            self._is_true_model = True
            self._config = None
            self._dynamics_fn = true_model_dynamics(true_model)
            self._mean_dynamics_fn = self._dynamics_fn
            self._penalized_dynamics_fn = None
            self._params = None
            self._replay = None
            return
        self._is_true_model = False
        self._config = config
        init, self._dynamics_fn = make_learned_dynamics(config)
        self._penalized_dynamics_fn = (make_penalized_dynamics(config)
                                       if config.plan_uncertainty_penalty > 0 else None)
        if config.propagation in ("mean", "mm"):
            # mm without noise returns the moment-matched mean, the mean of the member means.
            self._mean_dynamics_fn = self._dynamics_fn
        else:
            # Posterior-mean variant for the one-step lookahead: a [num_agents, S] probe
            # batch need not divide the ensemble, and a report is no noise sample.
            _, self._mean_dynamics_fn = make_learned_dynamics(
                dataclasses.replace(config, propagation="mean")
            )
        self._params = init(torch.Generator().manual_seed(seed)).to(self._device)
        self._replay = ReplayBuffer(
            config.dim_s, config.dim_u, validation_fraction=validation_fraction,
            max_size=replay_max_size, seed=seed,
        )
        self._trainer_init, self._train_step, self._eval_step = make_trainer(
            config, learning_rate=learning_rate, mesh=mesh)
        self._train_state = self._trainer_init(self._params.params)

    # ------------------------------------------------------------------ properties

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_true_model(self) -> bool:
        return self._is_true_model

    @property
    def config(self) -> Optional[LearnedDynamicsConfig]:
        return self._config

    @property
    def dynamics_fn(self) -> Callable:
        """``(DynamicsParams, state [B,S], action [B,U], noise=None) -> next_state [B,S]``."""
        return self._dynamics_fn

    @property
    def mean_dynamics_fn(self) -> Callable:
        """Posterior-mean dynamics (ensemble-averaged head means) for diagnostics; equals
        :attr:`dynamics_fn` unless propagation is member-partitioned (``ts1``/``ts_inf``)."""
        return self._mean_dynamics_fn

    @property
    def penalized_dynamics_fn(self) -> Optional[Callable]:
        """``(dp, state, action, noise=None) -> (next_state, penalty [B])`` when the config
        sets ``plan_uncertainty_penalty > 0`` (pessimistic planning), else ``None``."""
        return self._penalized_dynamics_fn

    @property
    def dynamics_params(self) -> Optional[DynamicsParams]:
        """The planning parameters: tensors without grad, replaced as a whole by ``train()``,
        ``set_params`` and ``load``."""
        return self._params

    @property
    def replay(self) -> Optional[ReplayBuffer]:
        return self._replay

    @property
    def train_state(self):
        """The trainer's state: trainable params, the Adam optimizer and the step count."""
        return self._train_state

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self._device)

    @torch.no_grad()
    def predict(self, states, actions) -> torch.Tensor:
        """One-step posterior-mean prediction through the whole normalize/denormalize chain,
        on the handler's device (a diagnostic path: the batch need not divide the
        ensemble)."""
        return self._mean_dynamics_fn(self._params, self._tensor(states),
                                      self._tensor(actions))

    def process_input(self, states, actions) -> torch.Tensor:
        """The network's input: the normalized states and actions, concatenated (a true model
        or an unnormalized config: the raw ones)."""
        states, actions = self._tensor(states), self._tensor(actions)
        if self._is_true_model or not self._config.normalized:
            return torch.cat([states, actions], dim=-1)
        stats = self._params.stats
        return torch.cat([stats.normalize_states(states), stats.normalize_actions(actions)],
                         dim=-1)

    def process_output(self, states, raw_targets) -> torch.Tensor:
        """The next state from a raw network output: denormalized (normalized configs), then
        added to ``states`` (a true model or ``predict_delta``)."""
        states, raw_targets = self._tensor(states), self._tensor(raw_targets)
        if not self._is_true_model and self._config.normalized:
            raw_targets = self._params.stats.denormalize_targets(raw_targets)
        if self._is_true_model or self._config.predict_delta:
            return states + raw_targets
        return raw_targets

    def set_params(self, dp: DynamicsParams) -> None:
        """Replaces the learned model's parameters (shapes must match the config), for
        planning and for further training; the optimizer starts afresh."""
        if self._is_true_model:
            raise RuntimeError("a true-model handler has no parameters")
        new, cur = flat_params(dp.params), flat_params(self._params.params)
        if len(new) != len(cur) or any(a.shape != b.shape for a, b in zip(new, cur)):
            raise ValueError("parameter shapes do not match the handler's config")
        dp = dp.to(self._device)
        self._params = dp.replace(params=_planning_copy(dp.params))
        self._train_state = self._trainer_init(dp.params)

    # ------------------------------------------------------------------ training

    def _batch(self, s, a, ns):
        """A numpy minibatch ``[E, B, .]`` on the device in one host-to-device copy."""
        packed = torch.from_numpy(np.concatenate([s, a, ns], axis=-1))
        if self._device.type == "cuda":
            packed = packed.pin_memory().to(self._device, non_blocking=True)
        dim_s, dim_u = self._config.dim_s, self._config.dim_u
        return torch.split(packed, [dim_s, dim_u, dim_s], dim=-1)

    def validation_losses(self, params, batch_size: int = 128) -> Optional[np.ndarray]:
        """Per-member validation loss ``[E]`` of ``params`` under the current stats: the
        size-weighted mean over the deterministic full validation split, read once; None
        when the split is empty."""
        total, count = None, 0
        for s, a, ns in self._replay.minibatches(batch_size, self._config.ensemble_size,
                                                 validation=True):
            v = self._eval_step(params, self._params.stats, *self._batch(s, a, ns))
            b = s.shape[1]
            total = v * b if total is None else total + v * b
            count += b
        return None if total is None else (total / count).cpu().numpy()

    def train(
        self,
        observations=None,
        actions=None,
        *,
        epochs: int = 30,
        batch_size: int = 128,
        patience: Optional[int] = None,
    ) -> dict:
        """Appends rollouts to the replay (if given) and runs ``epochs`` of minibatch Adam.

        ``observations``: sequence of [T+1, S] episode arrays (or [N, T+1, S]); ``actions``:
        matching [T, U] arrays. Returns ``train_loss`` (the mean member loss of the last
        epoch), ``val_loss``, ``replay_size``, ``train_calls`` and ``epochs_ran``.

        ``patience``: per-member early stopping. After each epoch the per-member validation
        loss is evaluated, each member's best weights are kept (any decrease), and training
        stops once ``patience`` epochs in a row improve no member by 1 % (relative). The
        planning params become the per-member bests; the optimizer keeps the latest weights.

        The losses of a step stay on the device; they are read once per epoch.
        """
        if self._is_true_model:
            raise RuntimeError("cannot train a true-model handler")
        if observations is not None:
            self._replay.add_rollouts(observations, actions)
        if len(self._replay) == 0:
            raise RuntimeError("replay buffer is empty; collect rollouts first")
        if patience is not None and patience < 1:
            raise ValueError(
                f"patience must be >= 1 (got {patience}); pass None to disable early stopping")

        if not self._stats_fitted or self._refit_normalizer:
            s, a, ns = self._replay.arrays(validation=False)
            targets = ns - s if self._config.predict_delta else ns
            stats = fit_normalizer(*(torch.as_tensor(x, device=self._device)
                                     for x in (s, a, targets)))
            self._params = self._params.replace(stats=stats)
            self._stats_fitted = True

        ensemble = self._config.ensemble_size
        stats = self._params.stats
        last_train = np.nan
        track = patience is not None
        best_val = np.full(ensemble, np.inf)
        # The per-member bests start at the weights this call starts from.
        best_params = _planning_copy(self._train_state.params) if track else None
        stall = 0
        epochs_ran = 0
        for _ in range(epochs):
            losses = []
            for s, a, ns in self._replay.minibatches(batch_size, ensemble):
                self._train_state, member_losses = self._train_step(
                    self._train_state, stats, *self._batch(s, a, ns))
                losses.append(member_losses)
            if losses:
                last_train = float(np.mean(torch.stack(losses).cpu().numpy()))
            epochs_ran += 1
            if not track:
                continue
            member_val = self.validation_losses(self._train_state.params, batch_size)
            if member_val is None:
                track = False  # no validation split: fixed epochs
                continue
            # Any decrease keeps that member's weights; only a >= 1 % relative decrease
            # (magnitude-based, the first finite loss always counts) resets the stall count.
            better = member_val < best_val
            improved = np.where(
                np.isinf(best_val),
                np.isfinite(member_val),
                (best_val - member_val) > 0.01 * np.maximum(np.abs(best_val), 1e-3),
            )
            current = self._train_state.params
            layers = net_layers(best_params)
            if better.any():
                sel = torch.as_tensor(better, device=self._device)
                # torch.where makes new tensors: the bests never alias what Adam updates.
                layers = [
                    {k: torch.where(sel.reshape((ensemble,) + (1,) * (v.dim() - 1)),
                                    net_layers(current)[i][k].detach(), v)
                     for k, v in layer.items()}
                    for i, layer in enumerate(layers)
                ]
            lv_min, lv_max = logvar_bounds(current)
            if lv_min is None:
                best_params = layers
            elif ensemble > 1 or better.any():
                # The shared bounds have no member axis: as in JAX, the bests carry the
                # current ones (at every epoch with E > 1, with the best net for E = 1).
                best_params = {"net": layers, "lv_min": lv_min.detach().clone(),
                               "lv_max": lv_max.detach().clone()}
            best_val = np.minimum(best_val, member_val)
            stall = 0 if improved.any() else stall + 1
            if stall >= patience:
                break

        if track:
            planning = best_params
        else:
            planning = _planning_copy(self._train_state.params)
        self._params = self._params.replace(params=planning)
        if track and np.isfinite(best_val).all():
            final_val = best_val  # the planning params are the per-member bests
        else:
            final_val = self.validation_losses(self._params.params, batch_size)
        val_loss = float(np.mean(final_val)) if final_val is not None else float("nan")
        self._train_calls += 1
        # The probabilistic heads' variance calibration on the validation split.
        calibration = None
        if self._config.probabilistic:
            cal = calibration_summary(self)
            if cal is not None:
                calibration = cal["variance_ratio"]
        if self._writer is not None:
            self._writer.scalar("system_model/train_loss", last_train, self._train_calls)
            self._writer.scalar("system_model/val_loss", val_loss, self._train_calls)
            if calibration is not None:
                self._writer.scalar("system_model/val_calibration_ratio", calibration,
                                    self._train_calls)
        logger.info(
            "dynamics train call %d: train_loss=%.5f val_loss=%.5f (replay: %d train / %d val)",
            self._train_calls, last_train, val_loss, self._replay.num_train, self._replay.num_val,
        )
        if self._save_dir is not None and self._train_calls % self._save_frequency == 0:
            self.save(self._save_dir)
        metrics = {
            "train_loss": last_train,
            "val_loss": val_loss,
            "replay_size": len(self._replay),
            "train_calls": self._train_calls,
            "epochs_ran": epochs_ran,
        }
        if calibration is not None:
            metrics["val_calibration_ratio"] = calibration
        return metrics

    # ------------------------------------------------------------------ checkpointing

    def save(self, directory: str) -> None:
        """Writes what the JAX package's ``DynamicsHandler.save`` writes: ``config.json`` and
        the Orbax pytree ``checkpoint/`` of params, Adam state, step, stats and replay (with
        its RNG state). The tree replaces the old one whole; a ``checkpoint.pt`` is removed."""
        from blackbox_mpc_torch.learning.orbax_write import save_pytree
        from blackbox_mpc_torch.models.convert import handler_to_numpy

        if self._is_true_model:
            raise RuntimeError("true-model handler has nothing to save")
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        meta, tree = handler_to_numpy(self)
        save_pytree(os.path.join(directory, _ORBAX_TREE), tree)
        # The payload would win over the new tree in load().
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(directory, _PAYLOAD))
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(meta, f)
        logger.info("saved dynamics checkpoint to %s", directory)

    @classmethod
    def load(cls, directory: str, **kwargs) -> "DynamicsHandler":
        """Restores a handler saved with :meth:`save` or with the JAX package's
        ``DynamicsHandler.save`` (an Orbax ``checkpoint/``), or a ``checkpoint.pt`` that an
        earlier version of the port wrote, which wins where present; ``kwargs`` go to the
        constructor (for example ``device``, ``learning_rate``). The planning params are the
        saved trainable ones, as in the JAX package."""
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "config.json")) as f:
            meta = json.load(f)
        version = int(meta.get("format_version", 0))
        if version > CHECKPOINT_FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {directory} has format_version={version}, newer than this "
                f"build supports ({CHECKPOINT_FORMAT_VERSION})")
        if (not os.path.exists(os.path.join(directory, _PAYLOAD))
                and os.path.isdir(os.path.join(directory, _ORBAX_TREE))):
            return _load_orbax(directory, meta, **kwargs)
        handler = cls(config=config_from_json(meta["config"]), **kwargs)
        payload = torch.load(os.path.join(directory, _PAYLOAD), map_location=handler.device,
                             weights_only=False)
        stats = NormalizerStats(*(payload["stats"][f] for f in STATS_FIELDS))
        handler._restore(payload["params"], stats, payload["replay"], meta)
        handler._train_state.optimizer.load_state_dict(payload["optimizer"])
        handler._train_state.step = int(payload["step"])
        logger.info("restored dynamics checkpoint from %s", directory)
        return handler

    def _restore(self, params, stats: NormalizerStats, replay_state: dict, meta: dict) -> None:
        """Sets params (trainable and planning), stats, replay and counters; the optimizer
        starts afresh (the caller loads its state)."""
        params = map_params(
            lambda v: torch.as_tensor(v, dtype=torch.float32, device=self._device), params)
        self._train_state = self._trainer_init(params)
        self._params = DynamicsParams(params=_planning_copy(params), stats=stats.to(self._device))
        self._replay.load_state_dict(replay_state)
        self._train_calls = int(meta["train_calls"])
        self._stats_fitted = bool(meta["stats_fitted"])


def _load_orbax(directory: str, meta: dict, **kwargs) -> DynamicsHandler:
    """A handler from the JAX package's checkpoint, by the JAX loader's rules: the replay
    restored as ``config.json``'s ``replay_keys`` list it; an unstamped checkpoint as saved,
    so one without ``replay["rng"]`` keeps the fresh stream (JAX ``handler.py:416-431``)."""
    from blackbox_mpc_torch.learning.orbax_read import restore_pytree
    from blackbox_mpc_torch.models.convert import handler_from_numpy

    tree = restore_pytree(os.path.join(directory, _ORBAX_TREE))
    replay = tree["replay"]
    keys = meta.get("replay_keys")
    if keys is not None:
        missing = sorted(set(keys) - set(replay))
        if missing:
            raise ValueError(f"checkpoint {directory}: replay keys {missing} of config.json "
                             "are not in the checkpoint")
        replay = {k: replay[k] for k in keys}
    handler = handler_from_numpy(meta, tree["params"], tree["opt_state"], tree["step"],
                                 tree["stats"], replay, **kwargs)
    logger.info("restored the JAX package's dynamics checkpoint from %s", directory)
    return handler
