"""The inputs of a run, made from ``--seed``: the weights (on the device, in a few large draws),
the normalizer's statistics, the observation stream of a closed loop and the replay of the
training cell. The same seed gives the same inputs; both the program and the reference get
them.
"""
from __future__ import annotations

import math
import zlib

import numpy as np

__all__ = ["sub_seed", "Weights", "make_weights", "make_stats", "ObservationStream",
           "replay_rollouts"]


def sub_seed(seed: int, name: str) -> int:
    """An independent 31-bit seed for the stream ``name`` of run ``seed`` (any whole number
    >= 0, however large)."""
    sequence = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(name.encode())])
    return int(sequence.generate_state(1, np.uint32)[0] >> 1)


class Weights:
    """The dynamics ensemble's weights: ``layers`` = [(w [E, in, out], b [E, out])], and with
    learned log-variance bounds ``lv_min``/``lv_max`` [S] (else None)."""

    def __init__(self, layers, lv_min=None, lv_max=None):
        self.layers, self.lv_min, self.lv_max = layers, lv_min, lv_max


def make_weights(config: dict, seed: int, device) -> Weights:
    """Weights by the configuration's ``weights.init``, drawn on ``device`` in one call:

    * ``glorot_uniform``: U(-l, l), l = sqrt(6 / (fan_in + fan_out)) (Keras ``Dense``);
    * ``truncated_normal_fan_in``: N(0, (gain / sqrt(fan_in))^2) clipped at two standard
      deviations (the PETS networks' law, whose initial gain is 0.5).

    Biases are zero; learned bounds start at ``weights.lv_min``/``lv_max``."""
    import torch

    m, spec = config["model"], config["weights"]
    out = m["dim_s"] * (2 if m.get("probabilistic", False) else 1)
    sizes = [m["dim_s"] + m["dim_u"], *m["hidden"], out]
    e = m["ensemble_size"]
    shapes = [(e, a, b) for a, b in zip(sizes[:-1], sizes[1:])]
    total = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    if spec["init"] == "glorot_uniform":
        flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    elif spec["init"] == "truncated_normal_fan_in":
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    else:
        raise ValueError(f"unknown weights.init {spec['init']!r}")
    layers, start = [], 0
    for e_, fan_in, fan_out in shapes:
        n = e_ * fan_in * fan_out
        raw = flat[start:start + n].view(e_, fan_in, fan_out)
        start += n
        if spec["init"] == "glorot_uniform":
            w = (2.0 * raw - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            w = raw.clamp(-2.0, 2.0) * (spec["gain"] / math.sqrt(fan_in))
        layers.append((w, torch.zeros((e_, fan_out), device=device)))
    lv_min = lv_max = None
    if m.get("probabilistic", False) and m.get("learn_logvar_bounds", False):
        lv_min = torch.full((m["dim_s"],), float(spec["lv_min"]), device=device)
        lv_max = torch.full((m["dim_s"],), float(spec["lv_max"]), device=device)
    return Weights(layers, lv_min, lv_max)


def make_stats(config: dict, seed: int) -> dict:
    """The normalizer's statistics, numpy float32 by field name, drawn from the
    configuration's ``stats`` laws: ``normal`` [mean, std] or ``uniform`` [low, high] per
    field."""
    rng = np.random.default_rng(sub_seed(seed, "stats"))
    m = config["model"]
    dims = {"states": m["dim_s"], "actions": m["dim_u"], "targets": m["dim_s"]}
    out = {}
    for name, (law, a, b) in config["stats"].items():
        n = dims[name.split("_", 1)[1]]
        draw = rng.normal(a, b, n) if law == "normal" else rng.uniform(a, b, n)
        out[name] = draw.astype(np.float32)
    return out


class ObservationStream:
    """Observation ``t`` of a closed loop: ``mean_states + std_states * x_t``, where ``x`` is a
    unit-variance autoregressive walk ``x_{t+1} = rho x_t + sqrt(1 - rho^2) eps`` from a
    seeded start. It does not depend on the program's outputs."""

    CHUNK = 1024

    def __init__(self, stats: dict, seed: int, rho: float, agents: int):
        self._rng = np.random.default_rng(sub_seed(seed, "observations"))
        self._mean, self._std = stats["mean_states"], stats["std_states"]
        self._rho, self._agents = float(rho), agents
        self._x = self._rng.standard_normal((agents, self._mean.size))
        self._rows: list = []

    def __call__(self, t: int) -> np.ndarray:
        """``[agents, S]`` float32."""
        while t >= len(self._rows):
            for _ in range(self.CHUNK):
                self._rows.append((self._mean + self._std * self._x).astype(np.float32))
                eps = self._rng.standard_normal(self._x.shape)
                self._x = self._rho * self._x + math.sqrt(1.0 - self._rho**2) * eps
        return self._rows[t]


def replay_rollouts(stats: dict, seed: int, rho: float, episodes: int, steps: int,
                    dim_u: int) -> tuple:
    """``episodes`` rollouts of ``steps`` transitions: observations ``[N, steps + 1, S]``
    from the stream's law (a fresh start each) and actions ``[N, steps, U]`` uniform in
    [-1, 1]; every transition differs."""
    rng = np.random.default_rng(sub_seed(seed, "replay"))
    dim_s = stats["mean_states"].size
    x = np.empty((episodes, steps + 1, dim_s))
    x[:, 0] = rng.standard_normal((episodes, dim_s))
    scale = math.sqrt(1.0 - rho**2)
    eps = rng.standard_normal((episodes, steps, dim_s))
    for t in range(steps):
        x[:, t + 1] = rho * x[:, t] + scale * eps[:, t]
    obs = (stats["mean_states"] + stats["std_states"] * x).astype(np.float32)
    actions = rng.uniform(-1.0, 1.0, (episodes, steps, dim_u)).astype(np.float32)
    return obs, actions
