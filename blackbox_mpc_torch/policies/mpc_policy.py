"""MPCPolicy: the user-facing facade wiring solver + evaluator + dynamics into ``act()``.

Counterpart of ``blackbox_mpc_tpu/policies/mpc_policy.py``. One ``act()`` runs the solve, the
optional exploration noise and the one-step lookahead on the policy's device, and copies the
action, predicted next observation and predicted reward to the host once.

Rollout backends (``rollout_backend``): ``"eager"`` (default; JAX's ``"xla"``), ``"kernel"``
(JAX's ``"pallas"``), ``"fused"`` (alias ``"fused_cem"``) and ``"auto"``, which resolves for
each solver (again at ``switch_solver``). Which backend may run which solve, and what
``"auto"`` picks, is decided in :mod:`blackbox_mpc_torch.ops.backend_select`, whose docstring
has the rules; the policy applies them each time it builds a solver.

``rng_impl`` has one value, None: a ``torch.Generator`` has one algorithm per device
(Philox4x32-10 on CUDA, MT19937 on the CPU), which the policy records for the serving artifact.
``metrics_writer`` gets ``rewards/predicted_reward`` once per ``act()``, from the host values
``act()`` returns.

``mesh`` (a :class:`~blackbox_mpc_torch.parallel.mesh.PopMesh`) shards the solve over its
ranks: ``"eager"`` through the sharded evaluator (``shard_axis="population"`` splits the
candidates, ``"agents"`` gives each rank whole agents), ``"fused"`` through the sharded fused
solvers. The policy runs on the mesh's device. Every rank builds the same policy with the same
seed and acts on the same observations: the draws, the actions and the solver state are then
the same on every rank, and every rank runs the same collectives in the same order.

``proposer`` (a :class:`~blackbox_mpc_torch.learning.proposer.PolicyProposer`): before every
solve its policy net is unrolled through the posterior-mean dynamics and the plan replaces the
solver's carried plan (``Solver.plan_field``). ``remat_rollout`` checkpoints each horizon step
of the eager evaluator (``torch.utils.checkpoint``), so the first-order solvers keep each
step's inputs instead of its activations for the backward pass; the gradients are the same.

Stochastic dynamics draw their rollout noise from a generator of their own, seeded from
``seed``, so the solver's draws are those of a deterministic model. Every evaluation of one
solve scores its candidates under the same noise (common random numbers: the generator is set
back to the solve's start before each draw), and the next solve draws new noise. Every
backend's evaluation takes its draws from one method, ``_evaluation_draws``.

On the card, the eager evaluations of a policy without a mesh or ``remat_rollout`` replay CUDA
graphs where grad is off (:class:`~blackbox_mpc_torch.rollout.evaluator.GraphedEvaluator`,
:attr:`MPCPolicy.rollout_graphs`): one graph per candidate shape, captured again when the
handler's parameters are replaced. The noise is still drawn eagerly, as before, and copied in.

A latent world model (:class:`~blackbox_mpc_torch.models.latent.LatentWorldModel`, TD-MPC2's)
stands in the handler's place, with its ``reward_fn`` as the reward function. ``act()`` then
encodes the observation into the latent and plans there: the solver's states are latents,
each candidate's return gains ``discount^H`` times the model's terminal value of the latent it
ends in, and ``act()`` returns the action, the predicted next latent and the predicted reward.
Each evaluation draws the value's inputs (``pi``'s normals and a pair of Q heads) from the
noise generator, fresh for every evaluation as TD-MPC2 draws them; the solver's draws are
those of any other model. It plans on ``"eager"`` (``"auto"`` picks it) on one device.

A recurrent world model (:class:`~blackbox_mpc_torch.models.rssm.RSSMWorldModel`, DreamerV3's
RSSM) stands there too, and the policy then carries a belief across ``act()`` calls
(:attr:`MPCPolicy.belief`: the feature ``[h, z]`` and the executed action, per agent, DreamerV3's
zeros after ``reset()``). Each ``act()`` first filters the observation from it (the model's
``observe``: the core steps ``h`` with the last code and action, the posterior's codes are
drawn from the noise generator), plans from the new feature and keeps it with the action it
returns; ``plan()`` filters from the same belief without keeping anything. Every imagined step
draws its codes from the prior by inverse CDF, from uniforms that each evaluation takes as an
input: one ``[H, rows, stoch]`` draw from the solve's noise generator, set back to the solve's
start before each evaluation (common random numbers, as for stochastic dynamics). It plans on
``"eager"`` (``"auto"`` picks it) on one device.

A goal-conditioned video world model (:class:`~blackbox_mpc_torch.models.vjepa2_ac.
VJEPA2ACWorldModel`, V-JEPA 2-AC's) stands there too. The observation is an image and a state
in one row, which ``act()`` encodes as for a latent model; the model keeps the goal image's
latents on the device (its ``set_goal``, once an episode), and each evaluation takes them as
the terminal value's input. Its rollouts carry the model's own state (the last frame and a
cache of the earlier frames' keys and values, written in place into a buffer the model keeps
per rollout shape), and a candidate's value is minus the L1 energy of its last frame to the
goal. It plans on ``"eager"`` (``"auto"`` picks it) on one device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.core.spaces import BoxSpace, as_box_space
from blackbox_mpc_torch.core.types import Bounds
# One definition of the streams for the policy and its artifact: ServingPolicy's reseed and
# its rng_impl gate hold only while the two agree.
from blackbox_mpc_torch.deploy.serving import NOISE_SEED_OFFSET, RNG_IMPLS, tree_leaves
from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.parallel.sharding import SHARD_AXES, make_sharded_evaluator
from blackbox_mpc_torch.policies.base import ModelBasedPolicy
from blackbox_mpc_torch.rollout.evaluator import GraphedEvaluator, make_trajectory_evaluator
from blackbox_mpc_torch.solvers import lookup
from blackbox_mpc_torch.solvers.base import exploration_noise as _exploration_noise
from blackbox_mpc_torch.utils.profiling import span

logger = logging.getLogger(__name__)

__all__ = ["MPCPolicy", "ROLLOUT_BACKENDS"]

ROLLOUT_BACKENDS = ("eager", "kernel", "fused", "auto")
# The JAX package's backend names, accepted for the port's.
BACKEND_ALIASES = {"xla": "eager", "pallas": "kernel", "fused_cem": "fused"}


def rollout_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The ``[H, rows, S]`` standard normals of one evaluation of stochastic dynamics."""
    return torch.randn(shape, generator=generator, device=device)


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
        metrics_writer=None,
        mesh=None,
        shard_axis: str = "population",
        rollout_backend: str = "eager",
        proposer=None,
        remat_rollout: bool = False,
        action_smoothness_weight: float = 0.0,
        rng_impl: str | None = None,
        device=None,
        **solver_kwargs,
    ):
        """``solver_kwargs`` are forwarded into the solver's config dataclass.

        ``reward_function`` is a torch ``(s [B,S], a [B,U], s' [B,S]) -> [B]`` function.
        ``device=None`` means ``"cuda"``; it must be the dynamics handler's device.
        ``seed`` seeds the policy's ``torch.Generator``, which every solve draws from, and a
        host generator of its own (the episode seeds of ``policies/pipeline.py``).
        ``proposer`` needs a plan-carrying solver (CEM, CEM-GD, CMA-ES, Gradient, PI2, MPPI,
        SPSA) on the policy's device. ``rng_impl`` must be None (see the module docstring).
        ``mesh`` and ``shard_axis``: see the module docstring; ``device`` may then be None or
        the mesh's device.
        """
        if rng_impl is not None:
            raise ValueError(
                f"rng_impl={rng_impl!r}: torch offers no choice of generator algorithm (a "
                "torch.Generator runs Philox4x32-10 on CUDA and MT19937 on the CPU); pass "
                "rng_impl=None")
        if shard_axis not in SHARD_AXES:
            raise ValueError(f"shard_axis must be one of {SHARD_AXES}, got {shard_axis!r}")
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r}, but this rank's device of the mesh is "
                                 f"{mesh.device}")
            device = mesh.device
        self._mesh = mesh
        self._shard_axis = shard_axis
        self._device = resolve_device(device)
        self._rng_impl = RNG_IMPLS.get(self._device.type, self._device.type)
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
        rollout_backend = BACKEND_ALIASES.get(rollout_backend, rollout_backend)
        if rollout_backend not in ROLLOUT_BACKENDS:
            raise ValueError(
                f"rollout_backend must be one of {ROLLOUT_BACKENDS} (or the JAX package's "
                f"names {', '.join(map(repr, BACKEND_ALIASES))}), got {rollout_backend!r}"
            )
        # A latent world model encodes the observation and ends each rollout in its value.
        self._encode = getattr(dynamics_handler, "encode", None)
        self._terminal_value = getattr(dynamics_handler, "terminal_value", None)
        # A recurrent world model filters each observation into the belief it carries.
        self._observe = getattr(dynamics_handler, "observe", None)
        self._belief = (None if self._observe is None
                        else dynamics_handler.initial_belief(num_agents))
        dyn_cfg = dynamics_handler.config
        self._stochastic = (dyn_cfg is not None
                            and getattr(dyn_cfg, "propagation", None) in ("ts_inf", "mm"))
        self._num_particles = dyn_cfg.num_particles if self._stochastic else 1
        self._penalized = dynamics_handler.penalized_dynamics_fn is not None
        # "auto" resolves per solver config in _build (it needs the population).
        self._requested_backend = rollout_backend
        if action_smoothness_weight < 0:
            raise ValueError(
                f"action_smoothness_weight must be >= 0, got {action_smoothness_weight}"
            )
        self._smoothness = float(action_smoothness_weight)
        self._writer = metrics_writer
        self._act_counter = 0
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._noise_generator = torch.Generator(device=self._device)
        self._noise_generator.manual_seed(seed + NOISE_SEED_OFFSET)
        self._noise_start = None  # the noise generator's state at the start of the solve
        self._host_rng = np.random.default_rng(seed)
        if proposer is not None and proposer.device != self._device:
            raise ValueError(f"proposer lives on {proposer.device}, policy on {self._device}")
        self._proposer = proposer
        self._proposer_field = None
        self._remat = bool(remat_rollout)
        self._solver_kwargs = dict(solver_kwargs)
        self._build(solver_name, strict_kwargs=True)

    # ------------------------------------------------------------------ construction

    def _build(self, solver_name: str, strict_kwargs: bool = False) -> None:
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
        from blackbox_mpc_torch.ops.backend_select import _FUSED_FACTORIES, resolve_backend

        handler = self._handler
        backend = resolve_backend(
            self._requested_backend, None if handler.is_true_model else handler.config,
            self._penalized, solver_name, config, self._num_agents, self._planning_horizon,
            self._bounds.dim, mesh=self._mesh, shard_axis=self._shard_axis,
            discount=self._discount, smoothness=self._smoothness, platform=self._device.type)
        if self._requested_backend == "auto":
            logger.info("rollout_backend auto -> %s", backend)
            if backend == "fused":  # a change of sampling law at the capacity threshold
                logger.info("auto-routing %s onto the fused generate-in-kernel backend: "
                            "candidates are clipped normals (+/-2 sigma), not the eager path's "
                            "truncated normals", solver_name)
        field = None
        if self._proposer is not None:
            # Validated before any state of the policy changes: a refused switch_solver leaves
            # the previous solver in place.
            probe = factory(config, self._bounds, lambda s, a: None)
            field = probe.plan_field
            if field is None:
                raise ValueError(
                    f"proposer= requires a plan-carrying solver (one declaring "
                    f"Solver.plan_field: CEM, CEM-GD, CMA-ES, Gradient, PI2, SPSA); "
                    f"{solver_name} declares none"
                )
            plan_size = self._num_agents * self._planning_horizon * self._bounds.dim
            size = getattr(probe.init(torch.Generator()), field).numel()
            if size != plan_size:
                raise ValueError(
                    f"{solver_name} plan field '{field}' has size {size}, expected "
                    f"A*H*U={plan_size}"
                )
        time_major = bool(getattr(config, "time_major", False))
        self._rollout_graphs = None  # _backend_evaluate sets it where the evaluations replay
        if backend == "fused":
            from blackbox_mpc_torch.ops import fused_cem, fused_sharded

            # Each factory stores its state in config.dtype (base.with_state_dtype) and reads
            # the handler's current parameters at every solve.
            name = _FUSED_FACTORIES[solver_name]
            args = (config, self._bounds, handler.config, lambda: handler.dynamics_params,
                    self._reward_fn)
            if self._mesh is None:
                solver = getattr(fused_cem, name)(*args)
            else:
                solver = getattr(fused_sharded, name.replace("make_", "make_sharded_"))(
                    *args, self._mesh)
        else:
            solver = factory(config, self._bounds, self._make_evaluate(time_major, backend))
        self._rollout_backend = backend
        self._solver_name = solver_name
        self._factory = factory
        self._config = config
        self._solver = solver
        self._solver_state = solver.init(self._generator)
        self._proposer_field = field
        if self._proposer is not None:
            from blackbox_mpc_torch.learning.proposer import make_plan_proposal_fn

            self._propose = make_plan_proposal_fn(
                self._proposer.config, self._bounds, self._handler.mean_dynamics_fn,
                self._planning_horizon)

    def _make_evaluate(self, time_major: bool, backend: str, params=None):
        """The solver's ``evaluate(obs, candidates)``, reading the dynamics parameters at every
        call: ``params()`` (default: the handler's current ones). Every backend's evaluation
        is one ``evaluator.evaluate`` span, which draws the evaluation's inputs
        (:meth:`_evaluation_draws`) and hands them to the backend's evaluator."""
        inner = self._backend_evaluate(time_major, backend, params)
        h_axis, p_axis = (0, 1) if time_major else (2, 0)

        def evaluate(obs, actions):
            with span("evaluator.evaluate"):
                return inner(obs, actions, *self._evaluation_draws(
                    actions.shape[h_axis], actions.shape[p_axis] * obs.shape[0]))

        return evaluate

    def _evaluation_draws(self, horizon: int, rows: int) -> tuple:
        """One evaluation's inputs after ``(obs, actions)``, for ``rows`` = candidates x
        agents: none for deterministic dynamics; stochastic dynamics' rollout noise ``[H,
        rows*K, S]``, from the solve's noise generator set back to the solve's start (common
        random numbers); a recurrent model's code uniforms ``[H, rows, stoch]``, drawn the same
        way; a model with a terminal value its ``(None, *value_inputs)``: a latent model's
        draws, fresh for every evaluation, or a goal-conditioned model's goal."""
        if self._stochastic or self._observe is not None:
            generator, start = self._noise_start
            generator.set_state(start)
            if self._observe is not None:
                return (self._handler.code_draws(generator, horizon, rows),)
            return (rollout_noise(generator, (horizon, rows * self._num_particles,
                                              self._handler.config.dim_s), self._device),)
        if self._terminal_value is not None:
            return (None, *self._handler.value_inputs(self._noise_start[0], rows))
        return ()

    def _backend_evaluate(self, time_major: bool, backend: str, params):
        """``_make_evaluate``'s evaluator on ``backend``, ``inner(obs, actions, noise=None,
        *value_inputs)``: the rollout kernel's, or the eager evaluator's (sharded over the
        mesh). The eager evaluator of the policy's own parameters on one device, without
        ``remat``, replays CUDA graphs (``self._rollout_graphs``); one of other parameters
        (the program ``deploy/export.py`` traces) stays eager."""
        handler, reward_fn, device = self._handler, self._reward_fn, self._device
        own = params is None
        if own:
            params = lambda: handler.dynamics_params  # noqa: E731
        if backend == "kernel":
            from blackbox_mpc_torch.ops.rollout_kernel import make_rollout_kernel_evaluator
            from blackbox_mpc_torch.rollout.evaluator import action_smoothness_penalty

            kernel_evaluate = make_rollout_kernel_evaluator(
                handler.config, reward_fn, discount=self._discount, device=device
            )
            weight, discount = self._smoothness, self._discount

            def evaluate(obs, actions, noise=None):
                rewards = kernel_evaluate(params(), obs, actions, noise)
                if weight > 0:
                    rewards = rewards - action_smoothness_penalty(actions, weight, discount)
                return rewards

            return evaluate

        dynamics_fn = (handler.penalized_dynamics_fn if self._penalized
                       else handler.dynamics_fn)
        options = dict(discount=self._discount, num_particles=self._num_particles,
                       action_smoothness_weight=self._smoothness,
                       dynamics_returns_penalty=self._penalized, time_major=time_major,
                       remat=self._remat)
        step = lambda s, a, noise=None: dynamics_fn(params(), s, a, noise)  # noqa: E731
        if self._terminal_value is not None:
            value = self._terminal_value
            options["terminal_value"] = lambda z, *draws: value(params(), z, *draws)
        begin = getattr(handler, "begin_rollout", None)
        if begin is not None:
            options["begin"] = begin
        if self._mesh is not None:
            return make_sharded_evaluator(step, reward_fn, self._mesh,
                                          shard_axis=self._shard_axis, **options)
        evaluate = make_trajectory_evaluator(step, reward_fn, device=device, **options)
        if own and not self._remat:
            evaluate = self._rollout_graphs = GraphedEvaluator(
                evaluate, lambda: tree_leaves(handler.dynamics_params),
                owned=getattr(handler, "rollout_buffer_bytes", None))
        return evaluate

    def _solve(self, solver_state, obs: torch.Tensor, t, generator: torch.Generator,
               noise_generator: torch.Generator, solver=None, dynamics_params=None,
               proposer_params=None):
        """One solve from ``solver_state`` (which it does not change): ``(action, new_state,
        aux)``. ``solver``, ``dynamics_params`` and ``proposer_params`` default to the
        policy's own (``deploy/export.py`` passes those of the program it traces)."""
        solver = self._solver if solver is None else solver
        if dynamics_params is None:
            dynamics_params = self._handler.dynamics_params
        if self._stochastic or self._terminal_value is not None or self._observe is not None:
            # The evaluations draw from this solve's noise generator (set back to the start
            # for stochastic dynamics). Its state lives on the host: reading and setting it
            # waits for nothing.
            self._noise_start = (noise_generator, noise_generator.get_state())
        if self._proposer is not None:
            # POPLIN-style seeding: the policy net's unroll replaces the carried plan (reshaped
            # for CMA-ES's flat [A, H*U] mean).
            if proposer_params is None:
                proposer_params = self._proposer.params
            proposed = self._propose(proposer_params, dynamics_params, obs)
            current = getattr(solver_state, self._proposer_field)
            solver_state = dataclasses.replace(solver_state, **{
                self._proposer_field: proposed.reshape(current.shape).to(current.dtype)})
        with span("solver.solve"):
            return solver.solve(solver_state, obs, t, generator)

    def _lookahead(self, dynamics_params, obs: torch.Tensor, action: torch.Tensor):
        """The one-step lookahead on the posterior-mean dynamics (the unpenalized head
        means): ``(predicted next state, predicted reward)``."""
        with span("policy.lookahead"):
            next_obs = self._handler.mean_dynamics_fn(dynamics_params, obs, action)
            return next_obs, self._reward_fn(obs, action, next_obs)

    def _step(self, solver_state, obs: torch.Tensor, t: int, generator: torch.Generator,
              noise_generator: torch.Generator, add_noise: bool):
        """One solve from ``solver_state`` (which it does not change), the optional
        exploration noise and the one-step lookahead: ``(action, new_state, aux, next_obs,
        pred_reward)``, all on the device."""
        action, new_state, aux = self._solve(solver_state, obs, t, generator, noise_generator)
        if add_noise:
            action = _exploration_noise(generator, action, self._bounds, self._noise_scale)
        next_obs, pred_reward = self._lookahead(self._handler.dynamics_params, obs, action)
        return action, new_state, aux, next_obs, pred_reward

    def _obs(self, observations, noise_generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, bool]:
        """The observations on the device, ``[A, S]``, and whether they came batched. A latent
        model's encoding stands in their place; a recurrent model's filtered feature from the
        carried belief, its codes drawn from ``noise_generator`` (the belief is not changed)."""
        with span("policy.obs_in"):
            obs = np.asarray(observations, dtype=np.float32)
            batched = obs.ndim > 1
            if not batched:
                obs = np.tile(obs[None], (self._num_agents, 1))
            if obs.shape[0] != self._num_agents:
                raise ValueError(
                    f"observations batch {obs.shape[0]} != num_agents {self._num_agents}"
                )
            obs = torch.as_tensor(obs, device=self._device)
        if self._encode is not None:
            obs = self._encode(obs)
        if self._observe is not None:
            obs = self._observe(self._belief, obs, noise_generator)
        return obs, batched

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

    @property
    def mesh(self):
        return self._mesh

    @property
    def shard_axis(self) -> str:
        return self._shard_axis

    @property
    def proposer(self):
        return self._proposer

    @property
    def rollout_backend(self) -> str:
        """The backend the current solver runs on (``"auto"`` resolved)."""
        return self._rollout_backend

    @property
    def belief(self):
        """The belief a recurrent world model's policy carries across ``act()`` calls, a
        :class:`~blackbox_mpc_torch.models.rssm.Belief`: the feature ``[h, z]`` [A, F] the last
        call filtered and planned from, and the action [A, U] it returned; None for a model
        that carries none. Each call replaces it whole."""
        return self._belief

    @property
    def rollout_graphs(self) -> GraphedEvaluator | None:
        """The current solver's graphed eager evaluator (its ``captures``, ``replays`` and
        ``graphs``; off the card it never engages), or None where no evaluation may replay a
        graph: another backend, a mesh or ``remat_rollout``."""
        return self._rollout_graphs

    @torch.no_grad()
    def act(self, observations, t: int = 0, exploration_noise: bool = False):
        """Solves one MPC step.

        Accepts an unbatched ``[S]`` observation (tiled across agents) or a batched
        ``[num_agents, S]`` array. Returns numpy ``(action, predicted_next_obs,
        predicted_reward)``, un-batched iff the input was un-batched. With a latent world model
        the observation is encoded first and the prediction is the next latent
        ``[..., latent_dim]``; with a recurrent world model the observation is filtered into the
        carried belief first and the prediction is the next feature ``[..., feat_dim]``, its
        codes the prior's probabilities.
        """
        with span("policy.act"):
            obs, batched = self._obs(observations, self._noise_generator)
            action, self._solver_state, _, next_obs, pred_reward = self._step(
                self._solver_state, obs, t, self._generator, self._noise_generator,
                bool(exploration_noise)
            )
            if self._belief is not None:
                self._belief = self._belief._replace(feat=obs, action=action)
            flat = torch.cat([action.reshape(-1), next_obs.reshape(-1),
                              pred_reward.reshape(-1)])
            with span("policy.wait"):
                flat = flat.float().cpu().numpy()
            n_a, n_o = action.numel(), next_obs.numel()
            action = flat[:n_a].reshape(action.shape)
            next_obs = flat[n_a:n_a + n_o].reshape(next_obs.shape)
            pred_reward = flat[n_a + n_o:].reshape(pred_reward.shape)
            self._act_counter += 1
            if self._writer is not None:
                self._writer.scalar(
                    "rewards/predicted_reward", float(np.mean(pred_reward)), self._act_counter
                )
            if batched:
                return action, next_obs, pred_reward
            return action[0], next_obs[0], pred_reward[0]

    @torch.no_grad()
    def plan(self, observations, t: int = 0):
        """Runs a solve and returns the full refined plan [A, H, U] + expected reward [A].

        A read-only query: the solver state and the belief are kept and the policy's
        generators are not advanced (the filter and the solve draw from copies of them).
        """
        copies = []
        for source in (self._generator, self._noise_generator):
            copies.append(torch.Generator(device=self._device))
            copies[-1].set_state(source.get_state())
        obs, _ = self._obs(observations, copies[1])
        _, _, aux, _, _ = self._step(self._solver_state, obs, t, *copies, False)
        return aux.plan.cpu().numpy(), aux.expected_reward.cpu().numpy()

    def reset(self) -> None:
        """Per-episode reset: the solver's state and, where the model carries one, the belief
        (DreamerV3's zeros)."""
        self._solver_state = self._solver.reset(self._solver_state, self._generator)
        if self._belief is not None:
            self._belief = self._handler.initial_belief(self._num_agents)

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
