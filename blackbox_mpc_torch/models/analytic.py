"""Analytic (closed-form) dynamics models and reward functions in torch.

Counterpart of ``blackbox_mpc_tpu/models/analytic.py``: each dynamics function returns the full
next state, ``dynamics(state [B,S], action [B,U]) -> next_state [B,S]``, and each reward takes
``(state, action, next_state) -> [B]``. The pendulum follows gymnasium's Pendulum-v1 (the
angular velocity is clipped before theta is integrated); the cart-pole is the continuous-force
Euler step of ``envs/native_cartpole.py``. A true-model ``DynamicsHandler`` plans through them
on the ``"eager"`` backend.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "ANALYTIC_MODELS",
    "angle_normalize",
    "cartpole_dynamics",
    "cartpole_reward",
    "pendulum_dynamics",
    "pendulum_reward",
]

_PI = math.pi

# gymnasium Pendulum-v1's constants.
_G = 10.0
_M = 1.0
_L = 1.0
_DT = 0.05
_MAX_SPEED = 8.0


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """Wraps an angle to [-pi, pi)."""
    return torch.remainder(x + _PI, 2.0 * _PI) - _PI


def pendulum_dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Pendulum step. state=[B,3] ([cos th, sin th, thdot]), action=[B,1] -> [B,3]."""
    th = torch.atan2(state[..., 1], state[..., 0])
    thdot = state[..., 2]
    u = action[..., 0]
    newthdot = thdot + (
        -3.0 * _G / (2.0 * _L) * torch.sin(th + _PI) + 3.0 / (_M * _L**2) * u
    ) * _DT
    newthdot = torch.clamp(newthdot, -_MAX_SPEED, _MAX_SPEED)
    newth = th + newthdot * _DT
    return torch.stack([torch.cos(newth), torch.sin(newth), newthdot], dim=-1)


def pendulum_reward(state: torch.Tensor, action: torch.Tensor,
                    next_state: torch.Tensor) -> torch.Tensor:
    """Swing-up reward -(th^2 + 0.1 thdot^2 + 0.001 ||u||^2), per batch row."""
    del next_state
    th = angle_normalize(torch.atan2(state[..., 1], state[..., 0]))
    thdot = state[..., 2]
    return -(th**2 + 0.1 * thdot**2) - 0.001 * torch.sum(torch.square(action), dim=-1)


# Continuous-force cart-pole; envs/native_cartpole.py steps the same constants.
_CP_GRAVITY = 9.8
_CP_MASSCART = 1.0
_CP_MASSPOLE = 0.1
_CP_LENGTH = 0.5
_CP_DT = 0.02
_CP_FORCE_SCALE = 10.0


def cartpole_dynamics(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Cart-pole Euler step. state=[B,4] (x, xdot, th, thdot), action=[B,1]."""
    x, x_dot, th, th_dot = (state[..., i] for i in range(4))
    force = _CP_FORCE_SCALE * action[..., 0]
    total_mass = _CP_MASSCART + _CP_MASSPOLE
    polemass_length = _CP_MASSPOLE * _CP_LENGTH
    costh, sinth = torch.cos(th), torch.sin(th)
    temp = (force + polemass_length * th_dot**2 * sinth) / total_mass
    thacc = (_CP_GRAVITY * sinth - costh * temp) / (
        _CP_LENGTH * (4.0 / 3.0 - _CP_MASSPOLE * costh**2 / total_mass)
    )
    xacc = temp - polemass_length * thacc * costh / total_mass
    return torch.stack(
        [
            x + _CP_DT * x_dot,
            x_dot + _CP_DT * xacc,
            th + _CP_DT * th_dot,
            th_dot + _CP_DT * thacc,
        ],
        dim=-1,
    )


def cartpole_reward(state: torch.Tensor, action: torch.Tensor,
                    next_state: torch.Tensor) -> torch.Tensor:
    """Upright-pole reward: cos(theta) minus small position and action penalties."""
    del next_state
    return (
        torch.cos(state[..., 2])
        - 0.01 * torch.square(state[..., 0])
        - 0.001 * torch.sum(torch.square(action), dim=-1)
    )


ANALYTIC_MODELS = {
    "pendulum": (pendulum_dynamics, pendulum_reward),
    "cartpole": (cartpole_dynamics, cartpole_reward),
}
