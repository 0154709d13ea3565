"""The dynamics ensemble written out plainly: per-column normalization, an MLP per member
(matrix product and bias, layer by layer), the probabilistic head with its soft log-variance
bounds (PETS), the normalized delta target added back to the state, and the propagations the
cells plan with:

* ``mean``: every member on every row, the members' head means averaged;
* ``ts_inf``: row ``i`` runs one member for the whole horizon and takes a Gaussian sample of
  its head at every step (PETS TS-infinity). The member of row ``i`` is
  ``ts_member_ids(rows, E)[i]``: ``arange(E)`` tiled over the rows, shuffled once by
  ``default_rng(0x75B007)``, the assignment the JAX package documents and the port keeps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import matmul

__all__ = ["Model", "ts_member_ids"]

EPS = 1e-7  # added to every std before dividing by it
FIXED_LOGVAR = (-10.0, 0.5)  # the soft bounds without learned ones (PETS' constants)


def ts_member_ids(rows: int, ensemble: int) -> np.ndarray:
    ids = np.tile(np.arange(ensemble, dtype=np.int32), rows // ensemble)
    np.random.default_rng(0x75B007).shuffle(ids)
    return ids


class Model:
    """``weights``: the run's ``streams.Weights``; ``stats``: numpy arrays by field name."""

    def __init__(self, config: dict, weights, stats: dict, device):
        m = config["model"]
        self.dim_s, self.dim_u = m["dim_s"], m["dim_u"]
        self.ensemble = m["ensemble_size"]
        self.probabilistic = m.get("probabilistic", False)
        self.propagation = m["propagation"]
        self.activation = m["activation"]
        self.layers = [(w.to(device), b.to(device)) for w, b in weights.layers]
        lo, hi = FIXED_LOGVAR
        self.lv_min = weights.lv_min.to(device) if weights.lv_min is not None else lo
        self.lv_max = weights.lv_max.to(device) if weights.lv_max is not None else hi
        self.stats = {k: torch.as_tensor(v, device=device) for k, v in stats.items()}
        self.device = device

    def _act(self, h):
        if self.activation == "tanh":
            return torch.tanh(h)
        if self.activation == "swish":
            return h * torch.sigmoid(h)
        raise ValueError(f"unknown activation {self.activation!r}")

    def net(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [E, B, in] -> [E, B, out], member e on its own rows."""
        h = x
        for i, (w, b) in enumerate(self.layers):
            h = matmul(h, w) + b[:, None, :]
            if i < len(self.layers) - 1:
                h = self._act(h)
        return h

    def net_input(self, s, a):
        st = self.stats
        return torch.cat([(s - st["mean_states"]) / (st["std_states"] + EPS),
                          (a - st["mean_actions"]) / (st["std_actions"] + EPS)], dim=-1)

    def bounded_logvar(self, raw):
        lv = self.lv_max - F.softplus(self.lv_max - raw)
        return self.lv_min + F.softplus(lv - self.lv_min)

    def to_state(self, s, target):
        st = self.stats
        return s + target * (st["std_targets"] + EPS) + st["mean_targets"]

    def mean_step(self, s, a):
        """Every member on every row, head means averaged: the next state."""
        x = self.net_input(s, a)
        raw = self.net(x.expand(self.ensemble, *x.shape))
        return self.to_state(s, raw[..., :self.dim_s].mean(0))

    def sampled_step(self, s, a, members, noise):
        """``members``: [E, B/E] row indices of each member (one member per row); ``noise``
        [B, S]: each row's head sample ``mean + exp(logvar / 2) * noise``."""
        x = self.net_input(s, a)
        raw_groups = self.net(x[members])  # [E, B/E, 2S]
        raw = torch.empty((s.shape[0], raw_groups.shape[-1]), device=s.device)
        raw[members.reshape(-1)] = raw_groups.reshape(-1, raw_groups.shape[-1])
        mean = raw[:, :self.dim_s]
        if not self.probabilistic:
            return self.to_state(s, mean)
        sample = mean + torch.exp(0.5 * self.bounded_logvar(raw[:, self.dim_s:])) * noise
        return self.to_state(s, sample)

    def member_rows(self, rows: int) -> torch.Tensor:
        ids = ts_member_ids(rows, self.ensemble)
        groups = [np.flatnonzero(ids == e) for e in range(self.ensemble)]
        return torch.as_tensor(np.stack(groups), device=self.device)
