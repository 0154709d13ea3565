"""Variance-calibration diagnostics for probabilistic dynamics heads.

Counterpart of ``blackbox_mpc_tpu/learning/calibration.py``. The ratio
``E[residual^2] / E[sigma^2]`` on held-out data says whether sampled propagation (``ts_inf``,
``mm``) injects noise of the right size: below 1 the heads are underconfident, above 1
overconfident. ``DynamicsHandler.train`` reports it for probabilistic configs
(``val_calibration_ratio``; ``system_model/val_calibration_ratio`` in the writer).

Every statistic is in the space the NLL is trained in (normalized targets when
``config.normalized``). The heads run on the handler's device in float32, as the JAX package
runs them; the statistics are then taken in float64 numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from blackbox_mpc_torch.models import transforms
from blackbox_mpc_torch.models.dynamics import bound_logvar, logvar_bounds, net_layers
from blackbox_mpc_torch.models.mlp import ensemble_apply

__all__ = ["head_moments", "calibration_summary"]


@torch.no_grad()
def head_moments(handler) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-member Gaussian heads against the targets of the validation split.

    Returns ``(mean [E, B, S], var [E, B, S], target [B, S])`` as float64 numpy arrays in
    training-target space, or ``None`` when the handler is deterministic, is a true-model
    handler, or has no validation data.
    """
    cfg = handler.config
    if cfg is None or not cfg.probabilistic or handler.replay is None:
        return None
    s, a, ns = handler.replay.arrays(validation=True)
    if len(s) == 0:
        return None
    dp = handler.dynamics_params
    stats = dp.stats
    s, a, ns = (torch.as_tensor(x, device=handler.device) for x in (s, a, ns))
    transform = (transforms.delta_transform if cfg.predict_delta
                 else transforms.identity_transform)
    target = transform(s, ns)
    if cfg.normalized:
        x = torch.cat([stats.normalize_states(s), stats.normalize_actions(a)], dim=-1)
        target = stats.normalize_targets(target)
    else:
        x = torch.cat([s, a], dim=-1)
    raw = ensemble_apply(net_layers(dp.params), x, config=cfg.mlp)  # [E, B, 2S]
    mean = raw[..., :cfg.dim_s]
    var = torch.exp(bound_logvar(raw[..., cfg.dim_s:], *logvar_bounds(dp.params)))
    return tuple(t.cpu().numpy().astype(np.float64) for t in (mean, var, target))


def calibration_summary(handler) -> Optional[dict]:
    """``E[residual^2]/E[sigma^2]`` and z-score coverage on the validation split.

    1.0 is calibrated. Coverage is the fraction of ``|z| <= 1`` and ``<= 2`` (a Gaussian
    gives 68.3 % and 95.4 %). ``None`` when not applicable (see :func:`head_moments`).
    """
    moments = head_moments(handler)
    if moments is None:
        return None
    mean, var, target = moments
    resid_sq = np.square(target[None] - mean)
    z = (target[None] - mean) / np.sqrt(var)
    return {
        "variance_ratio": float(resid_sq.mean() / var.mean()),
        "per_dim_variance_ratio": (resid_sq.mean(axis=(0, 1)) / var.mean(axis=(0, 1))),
        "coverage_1sigma": float((np.abs(z) <= 1.0).mean()),
        "coverage_2sigma": float((np.abs(z) <= 2.0).mean()),
        "val_points": int(target.shape[0]),
    }
