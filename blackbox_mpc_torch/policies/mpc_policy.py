"""MPCPolicy: the user-facing facade wiring solver + evaluator + dynamics into ``act()``.

Counterpart of ``blackbox_mpc_tpu/policies/mpc_policy.py``. One ``act()`` runs the solve, the
optional exploration noise and the one-step lookahead on the policy's device, and copies the
action, predicted next observation and predicted reward to the host once.

Rollout backends:

* ``"eager"`` (default; the counterpart of ``"xla"``): the eager PyTorch evaluator
  (:mod:`blackbox_mpc_torch.rollout.evaluator`), any dynamics;
* ``"kernel"`` (the counterpart of ``"pallas"``): the hand-written CUDA rollout kernel
  (:mod:`blackbox_mpc_torch.ops.rollout_kernel`), learned MLP dynamics with mean/ts1
  propagation;
* ``"fused"`` (alias ``"fused_cem"``): the generate-in-kernel solver family
  (:mod:`blackbox_mpc_torch.ops.fused_cem`), whose CUDA kernels draw the candidates, roll them
  out and reduce the weighted moments without storing the candidate tensor. Learned MLP
  dynamics with mean/ts1 propagation; solvers ``"CEM"`` (with the iCEM options), ``"PI2"``,
  ``"MPPI"``, ``"RandomSearch"`` and ``"CMA-ES"`` with ``diagonal=True``; undiscounted rewards
  and no smoothness penalty.

``"auto"`` is not ported yet. The JAX options ``mesh``, ``proposer``, ``remat_rollout``,
``rng_impl`` and ``metrics_writer`` have no counterpart here yet.
"""
from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.core.spaces import BoxSpace, as_box_space
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.policies.base import ModelBasedPolicy
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY, UNPORTED_SOLVERS, lookup
from blackbox_mpc_torch.solvers.base import exploration_noise as _exploration_noise

logger = logging.getLogger(__name__)

__all__ = ["MPCPolicy", "ROLLOUT_BACKENDS"]

ROLLOUT_BACKENDS = ("eager", "kernel", "fused")
# The fused solver family, by registry name: the factory of ops/fused_cem.py behind each.
_FUSED_FAMILY = {
    "CEM": "make_fused_cem",
    "PI2": "make_fused_pi2",
    "MPPI": "make_fused_pi2",
    "RandomSearch": "make_fused_random_search",
    "CMA-ES": "make_fused_sep_cma",  # requires diagonal=True (the factory checks)
}


class MPCPolicy(ModelBasedPolicy):
    def __init__(
        self,
        action_space: BoxSpace,
        reward_function: Callable,
        dynamics_handler: DynamicsHandler,
        solver_name: str = "CEM",
        num_agents: int = 1,
        planning_horizon: int = 50,
        exploration_noise_scale: float = 0.05,
        discount: float = 1.0,
        seed: int = 0,
        rollout_backend: str = "eager",
        action_smoothness_weight: float = 0.0,
        device=None,
        **solver_kwargs,
    ):
        """``solver_kwargs`` are forwarded into the solver's config dataclass.

        ``reward_function`` is a torch ``(s [B,S], a [B,U], s' [B,S]) -> [B]`` function.
        ``device=None`` means ``"cuda"``; it must be the dynamics handler's device.
        ``seed`` seeds the policy's ``torch.Generator``, which every solve draws from.
        """
        self._device = resolve_device(device)
        if dynamics_handler.device != self._device:
            raise ValueError(
                f"dynamics_handler lives on {dynamics_handler.device}, policy on {self._device}"
            )
        self._space = as_box_space(action_space)
        self._bounds = Bounds.from_space(self._space)
        self._reward_fn = reward_function
        self._handler = dynamics_handler
        self._num_agents = num_agents
        self._planning_horizon = planning_horizon
        self._noise_scale = exploration_noise_scale
        self._discount = discount
        if rollout_backend == "fused_cem":
            rollout_backend = "fused"
        if rollout_backend == "auto":
            raise NotImplementedError(
                "rollout_backend='auto' is not ported yet (ROADMAP Queue 1 item 9: the "
                "backend rule)"
            )
        if rollout_backend not in ROLLOUT_BACKENDS:
            raise ValueError(
                f"rollout_backend must be one of {ROLLOUT_BACKENDS} ('fused_cem' is an alias "
                f"of 'fused'), got {rollout_backend!r}"
            )
        if rollout_backend != "eager" and dynamics_handler.is_true_model:
            raise ValueError(f"rollout_backend={rollout_backend!r} requires learned MLP dynamics")
        self._rollout_backend = rollout_backend
        if action_smoothness_weight < 0:
            raise ValueError(
                f"action_smoothness_weight must be >= 0, got {action_smoothness_weight}"
            )
        if action_smoothness_weight > 0 and rollout_backend == "fused":
            raise ValueError(
                "action_smoothness_weight needs the candidate tensor; the fused CEM never "
                "materializes it — use the 'eager' or 'kernel' backend"
            )
        if rollout_backend == "fused" and discount != 1.0:
            raise ValueError(
                "the fused solver kernels sum undiscounted rewards; discount != 1.0 would "
                "be silently ignored — use the 'eager' or 'kernel' backend"
            )
        self._smoothness = float(action_smoothness_weight)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._solver_kwargs = dict(solver_kwargs)
        self._build(solver_name, strict_kwargs=True)

    # ------------------------------------------------------------------ construction

    def _build(self, solver_name: str, strict_kwargs: bool = False) -> None:
        known = solver_name in SOLVER_REGISTRY or solver_name in UNPORTED_SOLVERS
        # an unknown name gets lookup's KeyError
        if self._rollout_backend == "fused" and known and solver_name not in _FUSED_FAMILY:
            raise ValueError(
                "rollout_backend='fused' backs the generate-in-kernel solver family "
                f"(CEM, PI2, MPPI, RandomSearch, CMA-ES with diagonal=True), not "
                f"{solver_name}"
            )
        config_cls, factory = lookup(solver_name)
        valid = set(config_cls.__dataclass_fields__)
        kept = {k: v for k, v in self._solver_kwargs.items() if k in valid}
        dropped = set(self._solver_kwargs) - set(kept)
        if dropped and strict_kwargs:
            raise TypeError(
                f"unknown solver kwargs for {solver_name}: {sorted(dropped)}; "
                f"valid: {sorted(valid)}"
            )
        if dropped:
            logger.info("%s ignores solver kwargs %s", solver_name, sorted(dropped))
        config = config_cls(
            planning_horizon=self._planning_horizon, num_agents=self._num_agents, **kept
        )
        if getattr(config, "num_elite", 0) > config.population:
            raise ValueError(
                f"num_elite ({config.num_elite}) must be <= population ({config.population})"
            )
        time_major = bool(getattr(config, "time_major", False))
        if time_major and self._rollout_backend != "eager":
            raise ValueError(
                f"time_major=True requires the eager evaluator; the "
                f"{self._rollout_backend!r} backend's candidate contract is [P, A, H, U]"
            )
        if self._rollout_backend == "fused":
            from blackbox_mpc_torch.ops import fused_cem

            # Each factory stores its state in config.dtype (base.with_state_dtype) and reads
            # the handler's current parameters at every solve.
            handler = self._handler
            fused_factory = getattr(fused_cem, _FUSED_FAMILY[solver_name])
            solver = fused_factory(config, self._bounds, handler.config,
                                   lambda: handler.dynamics_params, self._reward_fn)
        else:
            solver = factory(config, self._bounds, self._make_evaluate(time_major))
        self._solver_name = solver_name
        self._config = config
        self._solver = solver
        self._solver_state = solver.init(self._generator)

    def _make_evaluate(self, time_major: bool):
        """The solver's ``evaluate(obs, candidates)``, reading the handler's current
        parameters at every call."""
        handler, reward_fn = self._handler, self._reward_fn
        if self._rollout_backend == "kernel":
            from blackbox_mpc_torch.ops.rollout_kernel import make_rollout_kernel_evaluator
            from blackbox_mpc_torch.rollout.evaluator import action_smoothness_penalty

            kernel_evaluate = make_rollout_kernel_evaluator(
                handler.config, reward_fn, discount=self._discount, device=self._device
            )
            weight, discount = self._smoothness, self._discount

            def evaluate(obs, actions):
                rewards = kernel_evaluate(handler.dynamics_params, obs, actions)
                if weight > 0:
                    rewards = rewards - action_smoothness_penalty(actions, weight, discount)
                return rewards

            return evaluate

        return make_trajectory_evaluator(
            lambda s, a: handler.dynamics_fn(handler.dynamics_params, s, a), reward_fn,
            discount=self._discount, action_smoothness_weight=self._smoothness,
            time_major=time_major, device=self._device,
        )

    def _step(self, obs: torch.Tensor, t: int, generator: torch.Generator, add_noise: bool):
        action, new_state, aux = self._solver.solve(self._solver_state, obs, t, generator)
        if add_noise:
            action = _exploration_noise(generator, action, self._bounds, self._noise_scale)
        # One-step lookahead on the posterior-mean dynamics: predicted next state + reward.
        next_obs = self._handler.mean_dynamics_fn(self._handler.dynamics_params, obs, action)
        pred_reward = self._reward_fn(obs, action, next_obs)
        return action, new_state, aux, next_obs, pred_reward

    def _obs(self, observations) -> tuple[torch.Tensor, bool]:
        obs = np.asarray(observations, dtype=np.float32)
        batched = obs.ndim > 1
        if not batched:
            obs = np.tile(obs[None], (self._num_agents, 1))
        if obs.shape[0] != self._num_agents:
            raise ValueError(
                f"observations batch {obs.shape[0]} != num_agents {self._num_agents}"
            )
        return torch.as_tensor(obs, device=self._device), batched

    # ------------------------------------------------------------------ public API

    @property
    def solver_name(self) -> str:
        return self._solver_name

    @property
    def dynamics_handler(self) -> DynamicsHandler:
        return self._handler

    @property
    def device(self) -> torch.device:
        return self._device

    @torch.no_grad()
    def act(self, observations, t: int = 0, exploration_noise: bool = False):
        """Solves one MPC step.

        Accepts an unbatched ``[S]`` observation (tiled across agents) or a batched
        ``[num_agents, S]`` array. Returns numpy ``(action, predicted_next_obs,
        predicted_reward)``, un-batched iff the input was un-batched.
        """
        obs, batched = self._obs(observations)
        action, self._solver_state, _, next_obs, pred_reward = self._step(
            obs, t, self._generator, bool(exploration_noise)
        )
        flat = torch.cat([action.reshape(-1), next_obs.reshape(-1), pred_reward.reshape(-1)])
        flat = flat.float().cpu().numpy()
        n_a, n_o = action.numel(), next_obs.numel()
        action = flat[:n_a].reshape(action.shape)
        next_obs = flat[n_a:n_a + n_o].reshape(next_obs.shape)
        pred_reward = flat[n_a + n_o:].reshape(pred_reward.shape)
        if batched:
            return action, next_obs, pred_reward
        return action[0], next_obs[0], pred_reward[0]

    @torch.no_grad()
    def plan(self, observations, t: int = 0):
        """Runs a solve and returns the full refined plan [A, H, U] + expected reward [A].

        A read-only query: the solver state is kept and the policy's generator is not
        advanced (the solve draws from a copy of it).
        """
        obs, _ = self._obs(observations)
        generator = torch.Generator(device=self._device)
        generator.set_state(self._generator.get_state())
        _, _, aux, _, _ = self._step(obs, t, generator, False)
        return aux.plan.cpu().numpy(), aux.expected_reward.cpu().numpy()

    def reset(self) -> None:
        """Per-episode solver-state reset."""
        self._solver_state = self._solver.reset(self._solver_state, self._generator)

    def switch_solver(self, solver_name: str, **solver_kwargs) -> None:
        """Swaps the trajectory solver, keeping dynamics handler and evaluator wiring.

        New kwargs are validated against the target solver; kwargs carried over from the
        previous solver that the target does not understand are dropped (logged)."""
        if solver_kwargs:
            self._solver_kwargs = dict(solver_kwargs)
            self._build(solver_name, strict_kwargs=True)
        else:
            self._build(solver_name)
        logger.info("switched solver to %s", solver_name)
