"""Trajectory evaluation: the rollout hot loop as an eager PyTorch loop over the horizon.

Counterpart of ``blackbox_mpc_tpu/rollout/evaluator.py`` (its ``lax.scan`` becomes a Python
loop). This is the ``"eager"`` backend of :class:`~blackbox_mpc_torch.policies.MPCPolicy`;
the ``"kernel"`` backend is :mod:`blackbox_mpc_torch.ops.rollout_kernel`.

Stochastic dynamics (PETS ``ts_inf``/``mm``) take their randomness as a tensor: ``noise``
``[H, B, S]`` of standard normals, step ``t`` reading ``noise[t]``, where JAX splits one key
into H step keys and draws ``normal(key_t, [B, S])``.

A terminal value (a latent world model's, ``models/latent.py``) is added to each return at the
state the rollout ends in, discounted by ``discount^H``; its own draws are inputs of the
evaluation (``value_inputs``), as the noise is.

A model whose rollout carries more than one tensor a row (``models/vjepa2_ac.py``: a frame's
latents and the keys and values of the frames before it) turns the tiled rows into a state of
its own before the first step (``begin``); its steps, reward and terminal value then take that
state, and the rollout's returns are still one tensor. Every other model's state is the
``[B, S]`` tensor itself.

``remat`` (JAX's ``jax.checkpoint`` of the scan body) runs each horizon step through
``torch.utils.checkpoint``: differentiating through the rollout (the Gradient and CEM-GD
solvers) then keeps each step's inputs only and computes the step again in the backward pass.

:class:`GraphedEvaluator` replays an evaluation on the card as one CUDA graph: the host then
launches one graph where the eager loop launches every op of every model step.
"""
from __future__ import annotations

import gc
import logging

import torch
from torch.utils.checkpoint import checkpoint

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.core.types import DynamicsFn, RewardFn, TrajectoryEvaluator
from blackbox_mpc_torch.utils.profiling import span

logger = logging.getLogger(__name__)

__all__ = [
    "make_trajectory_evaluator", "rollout_trajectories", "action_smoothness_penalty",
    "GraphedEvaluator", "GRAPH_MAX_MEMORY_SHARE", "NAN_REWARD",
]

# NaN rewards are clamped to this, matching the reference's guard.
NAN_REWARD = -1e6
# The most of the card's memory that the graphs of one GraphedEvaluator may hold (their pool
# and their static inputs): a pool is the evaluation's working memory, kept for the graph's
# life and lent to nothing else. A larger evaluation is device-bound, where a graph saves
# nothing, and stays eager.
GRAPH_MAX_MEMORY_SHARE = 1 / 16


def rollout_trajectories(
    dynamics_fn: DynamicsFn,
    reward_fn: RewardFn,
    initial_states: torch.Tensor,  # [B, S]
    action_sequences: torch.Tensor,  # [B, H, U] ([H, B, U] when time_major)
    *,
    discount: float = 1.0,
    return_states: bool = False,
    noise: torch.Tensor | None = None,
    dynamics_returns_penalty: bool = False,
    time_major: bool = False,
    remat: bool = False,
    terminal_value=None,
    begin=None,
):
    """Rolls a batch of action sequences through the dynamics, accumulating reward.

    Returns total_reward [B] (and the visited states [H, B, S] if requested). The discount
    is carried by repeated multiplication, as the JAX scan carries it. ``noise`` ([H, B, S]):
    step ``t`` calls ``dynamics_fn(state, action, noise[t])``; None keeps the two-argument
    call. ``dynamics_returns_penalty``: the dynamics return ``(next_state, penalty [B])`` and
    each step adds ``discount^t * (r - penalty)``. ``terminal_value`` (``state [B, S] -> [B]``)
    adds ``discount^H * terminal_value(final state)``; None adds nothing. ``begin``
    (``(initial_states, H) -> state``): the model's own state of the rollout, which the steps
    carry in place of the rows (no visited states are returned then); None carries the rows.

    ``remat``: each step runs under ``torch.utils.checkpoint`` (non-reentrant), which stores
    the step's inputs instead of its activations and recomputes them in the backward pass.
    The step's noise is one of those inputs, so a recomputation sees the same draws; the
    gradients are the same as without it.
    """
    actions = action_sequences if time_major else action_sequences.transpose(0, 1)
    state = initial_states
    total = torch.zeros(state.shape[0], dtype=state.dtype, device=state.device)
    disc = torch.ones((), dtype=state.dtype, device=state.device)
    states = []
    if begin is not None:
        if return_states:
            raise ValueError("a rollout that carries the model's own state returns no visited "
                             "states")
        state = begin(state, len(actions))

    def step(state, actions_t, noise_t):
        with span("models.step"):
            out = (dynamics_fn(state, actions_t) if noise_t is None
                   else dynamics_fn(state, actions_t, noise_t))
            next_state, penalty = out if dynamics_returns_penalty else (out, None)
            r = reward_fn(state, actions_t, next_state)
            if penalty is not None:
                r = r - penalty
            return next_state, r

    for t, actions_t in enumerate(actions):
        noise_t = None if noise is None else noise[t]
        if remat and torch.is_grad_enabled():
            # The step draws nothing, so there is no RNG state to save and restore.
            next_state, r = checkpoint(step, state, actions_t, noise_t, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            next_state, r = step(state, actions_t, noise_t)
        total = total + disc * r
        disc = disc * discount
        state = next_state
        if return_states:
            states.append(next_state)
    if terminal_value is not None:
        total = total + disc * terminal_value(state)
    if return_states:
        return total, torch.stack(states)
    return total


def action_smoothness_penalty(
    action_sequences: torch.Tensor, weight: float, discount: float = 1.0,
    time_major: bool = False,
) -> torch.Tensor:
    """``w * sum_t discount^t * ||a_t - a_{t-1}||^2`` over [P, A, H, U] plans -> [P, A]
    (``[H, P, A, U]`` plans when ``time_major``)."""
    h_axis = 0 if time_major else 2
    horizon = action_sequences.shape[h_axis]
    diffs = torch.sum(torch.square(torch.diff(action_sequences, dim=h_axis)), dim=-1)
    if discount != 1.0:
        disc = torch.tensor(
            discount, dtype=diffs.dtype, device=diffs.device
        ) ** torch.arange(1, horizon, device=diffs.device)
        diffs = diffs * (disc[:, None, None] if time_major else disc)
    return weight * torch.sum(diffs, dim=h_axis)


def make_trajectory_evaluator(
    dynamics_fn: DynamicsFn,
    reward_fn: RewardFn,
    *,
    discount: float = 1.0,
    nan_guard: bool = True,
    num_particles: int = 1,
    action_smoothness_weight: float = 0.0,
    dynamics_returns_penalty: bool = False,
    time_major: bool = False,
    remat: bool = False,
    device=None,
    terminal_value=None,
    begin=None,
) -> TrajectoryEvaluator:
    """Builds ``evaluate(initial_states [A,S], action_sequences [P,A,H,U], noise=None,
    *value_inputs) -> rewards [P,A]``.

    The initial state of agent ``a`` is tiled across the population agent-minor, each
    candidate is rolled out for H steps, the discounted rewards are summed, the smoothness
    cost is subtracted and NaN rewards become -1e6. ``time_major``: candidates are
    ``[H, P, A, U]``. Inputs must lie on ``device``.

    ``noise`` (stochastic dynamics): ``[H, P*K*A, S]`` standard normals with
    ``K = num_particles``. Each candidate is then rolled out K times, particle ``j`` of
    candidate ``i`` on rows ``(i*K + j)*A + a``, and the K returns are averaged (the PETS
    estimator); without noise K is 1. ``dynamics_returns_penalty`` and ``remat``: see
    :func:`rollout_trajectories`.

    ``terminal_value`` (``(final states [P*K*A, S], *value_inputs) -> [P*K*A]``): each
    rollout's return gains ``discount^H`` times the value of the state it ends in, computed
    from the evaluation's ``value_inputs`` (tensors whose draws the caller made). ``begin``:
    see :func:`rollout_trajectories`.
    """
    if num_particles < 1:
        raise ValueError(f"num_particles must be >= 1, got {num_particles}")
    if action_smoothness_weight < 0:
        raise ValueError(
            f"action_smoothness_weight must be >= 0, got {action_smoothness_weight}"
        )
    device = resolve_device(device)

    def evaluate(initial_states: torch.Tensor, action_sequences: torch.Tensor,
                 noise: torch.Tensor | None = None, *value_inputs) -> torch.Tensor:
        if initial_states.device != device or action_sequences.device != device:
            raise ValueError(f"inputs must be on {device}")
        k = num_particles if noise is not None else 1
        if time_major:
            horizon, pop, agents, dim_u = action_sequences.shape
        else:
            pop, agents, horizon, dim_u = action_sequences.shape
        # [P, A, H, U] -> [P*K, A, H, U]: particle j of candidate i is row i*K + j.
        repeated = (action_sequences if k == 1
                    else action_sequences.repeat_interleave(k, dim=1 if time_major else 0))
        if time_major:
            flat_actions = repeated.reshape(horizon, pop * k * agents, dim_u)
        else:
            flat_actions = repeated.reshape(pop * k * agents, horizon, dim_u)
        if noise is not None and noise.shape[:2] != (horizon, pop * k * agents):
            raise ValueError(f"noise must be [H, P*K*A, S] = [{horizon}, {pop * k * agents}, "
                             f"S], got {list(noise.shape)}")
        # [A, S] -> [P*K*A, S], agent minor (as tf.tile(current_states, [pop, 1])).
        flat_states = initial_states.repeat(pop * k, 1)
        value = (None if terminal_value is None
                 else lambda final: terminal_value(final, *value_inputs))
        total = rollout_trajectories(
            dynamics_fn, reward_fn, flat_states, flat_actions, discount=discount, noise=noise,
            dynamics_returns_penalty=dynamics_returns_penalty, time_major=time_major,
            remat=remat, terminal_value=value, begin=begin,
        )
        rewards = total.reshape(pop, k, agents).mean(1) if k > 1 else total.reshape(pop, agents)
        if action_smoothness_weight > 0.0:
            # Every particle of a candidate carries its plan's penalty: take the plans once.
            rewards = rewards - action_smoothness_penalty(
                action_sequences, action_smoothness_weight, discount, time_major=time_major
            )
        if nan_guard:
            rewards = torch.where(torch.isnan(rewards), NAN_REWARD, rewards)
        return rewards

    return evaluate


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _memory(device, release: bool = False) -> tuple:
    """``(reserved, total)``: the bytes the caching allocator holds on the card, after
    releasing its free cache where ``release``, and the card's memory."""
    if release:
        torch.cuda.empty_cache()
    return (torch.cuda.memory_reserved(device),
            torch.cuda.get_device_properties(device).total_memory)


def _graphable(inputs) -> bool:
    """Whether an evaluation of ``inputs`` may replay a graph: contiguous inputs on the card,
    grad disabled (a graph keeps no autograd history), and no ``torch.compile`` or
    ``torch.export`` tracing (whose tensors have no memory to capture)."""
    return (not torch.is_grad_enabled() and not torch.compiler.is_compiling()
            and all(x is None or (_on_card(x) and x.is_contiguous()) for x in inputs))


class _Graph:
    """One evaluation captured: static input buffers of the call's shapes, the graph, and its
    static rewards. ``pool`` is the memory pool it shares (None: a new one, then
    ``self.pool``); ``bytes`` is what the capture added to the card's reserved memory."""

    def __init__(self, evaluate, inputs, pool):
        device = inputs[0].device
        stream = torch.cuda.current_stream(device)
        before, _ = _memory(device, release=True)  # as the capture does: the growth is its own
        self.inputs = [None if x is None else torch.empty_like(x) for x in inputs]
        self.graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: one could destroy a dead evaluator's
        # graph there, which a capture does not allow (torch.cuda.graph no longer collects
        # before it begins).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.rewards = evaluate(*self.inputs)
        except RuntimeError:
            torch.cuda.set_stream(stream)  # a failed capture leaves its own stream current
            raise
        finally:
            if collecting:
                gc.enable()
        self.pool = self.graph.pool()
        self.bytes = _memory(device)[0] - before

    def __call__(self, inputs) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            if x is not None:
                static.copy_(x)
        self.graph.replay()
        return self.rewards.clone()  # the next replay writes the static rewards again


class GraphedEvaluator:
    """An evaluator of :func:`make_trajectory_evaluator`, ``evaluate(initial_states,
    action_sequences, noise=None, *value_inputs)``, whose evaluations on the card replay CUDA
    graphs. The noise and the value's inputs are inputs of the graph like the others.

    One graph per shape of the inputs. The first evaluation of a shape runs eagerly (its lazy
    set-up, such as ``member_permutation``'s constants, happens there) and then captures the
    evaluation over static input buffers. Every later evaluation of that shape copies its
    inputs into those buffers, replays the graph and returns a copy of its rewards. A replay
    runs the eager evaluation's kernels in the same order on the same values: the rewards are
    the same bits.

    ``reads()`` gives every tensor the evaluation reads besides its inputs (the dynamics'
    parameters and normalizer statistics). The graphs are keyed on their identity (address,
    shape, dtype, strides) and version counters (:meth:`key`) and hold them: where one is
    replaced (``DynamicsHandler.train``, ``set_params``) or edited in place, the next
    evaluation drops every graph and runs eagerly, so whatever the dynamics derive from their
    parameters on the way (the RSSM's packed block weights, ``ops/block_gemm.py::packed``) is
    derived anew before the next capture.

    It engages only for contiguous inputs on the card with grad disabled and outside
    ``torch.compile``/``torch.export`` tracing; any other call is the eager evaluation. Where a
    capture fails (a host sync inside the dynamics or the reward, say), the evaluations stay
    eager until the key changes, logged once. Where the first evaluation's working memory and
    inputs would take the graphs past ``GRAPH_MAX_MEMORY_SHARE`` of the card, the shape stays
    eager. ``owned()`` (None: 0) gives the bytes of the buffers the dynamics keep for their
    rollouts outside any graph's pool (``models/vjepa2_ac.py``'s cache of earlier frames): they
    are no working memory of a graph, and the first evaluation's growth of them is left out of
    that sum. ``captures`` and ``replays`` count the graphs captured and replayed; ``graphs``
    is the number alive and ``graph_bytes`` the memory their captures reserved.
    """

    def __init__(self, evaluate: TrajectoryEvaluator, reads, owned=None):
        self._evaluate = evaluate
        self._reads = reads
        self._owned = owned if owned is not None else (lambda: 0)
        self._key = None
        self._held = ()  # the tensors of the key, kept alive while graphs read them
        self._graphs = {}  # the inputs' shapes and dtypes -> _Graph, or None: eager
        self._pool = None  # one memory pool for the key's graphs, replayed one at a time
        self._bytes = 0
        self._eager = False  # a capture under this key failed
        self._logged = set()
        self.captures = 0
        self.replays = 0

    @property
    def graphs(self) -> int:
        return sum(graph is not None for graph in self._graphs.values())

    @property
    def graph_bytes(self) -> int:
        return self._bytes

    def key(self, held=None) -> tuple:
        """The identity and version of the tensors ``reads()`` gives (or ``held``). A tensor
        made under ``torch.inference_mode()`` has no version counter and counts as version 0:
        an edit of it in place is read by the replay as it is, and nothing derived from it
        is kept (``ops/block_gemm.py::packed`` refuses it)."""
        held = self._reads() if held is None else held
        return tuple((t.data_ptr(), t.shape, t.dtype, t.stride(),
                      0 if t.is_inference() else t._version) for t in held)

    def __call__(self, initial_states, action_sequences, noise=None,
                 *value_inputs) -> torch.Tensor:
        inputs = (initial_states, action_sequences, noise, *value_inputs)
        if not _graphable(inputs):
            return self._evaluate(*inputs)
        held = self._reads()
        key = self.key(held)
        if key != self._key:
            self._graphs, self._pool, self._bytes, self._eager = {}, None, 0, False
            self._key, self._held = key, held
        shapes = tuple(None if x is None else (x.shape, x.dtype) for x in inputs)
        graph = self._graphs.get(shapes)
        if graph is not None:
            with span("evaluator.replay"):
                self.replays += 1
                return graph(inputs)
        if self._eager or shapes in self._graphs:
            return self._evaluate(*inputs)
        before, card = _memory(initial_states.device, release=True)
        owned = self._owned()
        rewards = self._evaluate(*inputs)
        need = (_memory(initial_states.device)[0] - before - (self._owned() - owned)
                + sum(x.nbytes for x in inputs if x is not None))
        with span("evaluator.capture"):
            self._graphs[shapes] = self._capture(inputs, need, card)
        return rewards

    def _capture(self, inputs, need: int, card: int) -> _Graph | None:
        """A graph of ``inputs``' shapes, or None; ``need``: the eager evaluation's working
        memory and the inputs' bytes, ``card``: the card's memory."""
        if self._bytes + need > GRAPH_MAX_MEMORY_SHARE * card:
            self._log("memory", "no CUDA graph of a rollout of %s: with %.2f GB of working "
                      "memory and inputs, the graphs would pass GRAPH_MAX_MEMORY_SHARE of the "
                      "card; it stays eager", [None if x is None else list(x.shape)
                                               for x in inputs], need / 1e9)
            return None
        try:
            graph = _Graph(self._evaluate, inputs, self._pool)
        except RuntimeError as err:
            self._eager = True
            self._log("failure", "no CUDA graph of the rollout (it stays eager until the "
                      "dynamics' parameters change): %s", err)
            return None
        self._pool = graph.pool
        self._bytes += graph.bytes
        self.captures += 1
        return graph

    def _log(self, kind: str, message: str, *args) -> None:
        if kind not in self._logged:
            self._logged.add(kind)
            logger.warning(message, *args)
