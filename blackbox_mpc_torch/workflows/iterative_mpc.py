"""Iterative model-based RL: alternate collecting with MPC and retraining the dynamics model.

Counterpart of ``blackbox_mpc_tpu/workflows/iterative_mpc.py``: bootstrap with random-policy
rollouts and a first training, build an MPC policy on the learned model, then N refinements of
collect-with-MPC and retrain. Returns ``(handler, policy)``. The policy reads the handler's
current parameters at every solve, so each refinement plans on the weights of the last
``train()``, on every rollout backend.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional

import torch

from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.learning.orbax_write import save_pytree
from blackbox_mpc_torch.models.convert import proposer_to_numpy
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
from blackbox_mpc_torch.policies.mpc_policy import MPCPolicy
from blackbox_mpc_torch.policies.random_policy import RandomPolicy
from blackbox_mpc_torch.workflows.dynamics_learning import learn_dynamics_from_policy

logger = logging.getLogger(__name__)

__all__ = ["learn_dynamics_iteratively_w_mpc"]

# The proposer's checkpoint beside handler/: the JAX package's Orbax tree. Earlier versions of
# the port wrote a torch.save payload in it instead, which resume still reads.
_PROPOSER_TREE = "proposer"
_PROPOSER_PAYLOAD = "proposer.pt"


def learn_dynamics_iteratively_w_mpc(
    env,
    reward_function: Callable,
    solver_name: str = "CEM",
    planning_horizon: int = 50,
    number_of_initial_rollouts: int = 5,
    number_of_rollouts_per_refinement: int = 1,
    number_of_refinement_steps: int = 5,
    rollout_horizon: int = 200,
    dynamics_config: Optional[LearnedDynamicsConfig] = None,
    handler: Optional[DynamicsHandler] = None,
    epochs: int = 30,
    batch_size: int = 128,
    patience: Optional[int] = None,
    learning_rate: float = 1e-3,
    exploration_noise: bool = False,
    metrics_writer=None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    overlap: bool = False,
    behavior_cloning: bool = False,
    bc_epochs: int = 20,
    bc_hidden: tuple = (64, 64),
    solver_learning_rate: Optional[float] = None,
    device=None,
    **solver_kwargs,
):
    """The full MBRL loop. ``solver_kwargs`` go to :class:`MPCPolicy` and from there into the
    solver config (``population``, ``rollout_backend``, ...).

    ``checkpoint_dir``: the handler (model, optimizer state, normalizer, replay) and the loop
    counter (``loop_state.json``) are checkpointed after the bootstrap and after every
    refinement; ``resume=True`` restores them and continues at the next refinement.
    ``solver_learning_rate`` goes to the solver config as ``learning_rate`` (Gradient) or
    ``gd_learning_rate`` (CEM-GD), since the workflow's ``learning_rate`` is the model's.
    ``device`` (default ``"cuda"``) is the handler's and the policy's.

    ``overlap=True``: the refinements collect through the speculative pipeline
    (``perform_rollouts(overlap=True)``). ``behavior_cloning=True`` (POPLIN-style): a
    :class:`~blackbox_mpc_torch.learning.proposer.PolicyProposer` (hidden widths
    ``bc_hidden``) is behaviour-cloned for ``bc_epochs`` on the replay after the bootstrap and
    after every refinement (``proposer/bc_loss``) and seeds the solver's plan at every solve;
    it is returned as ``policy.proposer`` and checkpointed beside ``handler/`` as the Orbax
    tree ``proposer/``. ``resume=True`` restores it.

    The checkpoints are the JAX package's format, written in its order (``handler/``,
    ``proposer/``, ``loop_state.json``), so the JAX package's loop resumes a directory the port
    wrote, and the port resumes one the JAX package wrote (or its legacy ``proposer.npy``).
    Each save replaces the whole tree: no directory holds two formats.
    """
    if solver_learning_rate is not None:
        lr_field = "gd_learning_rate" if solver_name == "CEM-GD" else "learning_rate"
        solver_kwargs[lr_field] = solver_learning_rate
    num_agents = env.num_envs
    start_refinement = 0
    if resume:
        if checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        state_path = os.path.join(checkpoint_dir, "loop_state.json")
        if os.path.exists(state_path):
            with open(state_path) as f:
                loop_state = json.load(f)
            handler = DynamicsHandler.load(
                os.path.join(checkpoint_dir, "handler"),
                learning_rate=learning_rate,
                metrics_writer=metrics_writer,
                device=device,
            )
            start_refinement = int(loop_state["completed_refinements"])
            number_of_initial_rollouts = 0
            logger.info("resumed MBRL loop at refinement %d", start_refinement)

    def _checkpoint(completed: int):
        if checkpoint_dir is None:
            return
        os.makedirs(checkpoint_dir, exist_ok=True)
        handler.save(os.path.join(checkpoint_dir, "handler"))
        if proposer is not None:
            save_pytree(os.path.join(checkpoint_dir, _PROPOSER_TREE), proposer_to_numpy(proposer))
        with open(os.path.join(checkpoint_dir, "loop_state.json"), "w") as f:
            json.dump({"completed_refinements": completed}, f)

    if number_of_initial_rollouts > 0:
        random_policy = RandomPolicy(env.action_space, num_agents=num_agents, seed=seed)
        logger.info("collecting %d bootstrap rollouts with a random policy",
                    number_of_initial_rollouts)
        handler, _, _ = learn_dynamics_from_policy(
            env,
            random_policy,
            handler=handler,
            dynamics_config=dynamics_config,
            number_of_rollouts=number_of_initial_rollouts,
            rollout_horizon=rollout_horizon,
            epochs=epochs,
            batch_size=batch_size,
            patience=patience,
            learning_rate=learning_rate,
            metrics_writer=metrics_writer,
            device=device,
        )
    elif handler is None:
        raise ValueError("need number_of_initial_rollouts > 0 or a pre-trained handler")

    proposer = None
    if behavior_cloning:
        proposer = _make_proposer(env, handler, checkpoint_dir if resume else None,
                                  bc_epochs, tuple(bc_hidden), seed)

    policy = MPCPolicy(
        action_space=env.action_space,
        reward_function=reward_function,
        dynamics_handler=handler,
        solver_name=solver_name,
        num_agents=num_agents,
        planning_horizon=planning_horizon,
        seed=seed,
        metrics_writer=metrics_writer,
        device=handler.device,
        proposer=proposer,
        **solver_kwargs,
    )
    if start_refinement == 0:
        _checkpoint(0)
    for i in range(start_refinement, number_of_refinement_steps):
        logger.info("refinement step %d/%d", i + 1, number_of_refinement_steps)
        handler, result, metrics = learn_dynamics_from_policy(
            env,
            policy,
            handler=handler,
            number_of_rollouts=number_of_rollouts_per_refinement,
            rollout_horizon=rollout_horizon,
            epochs=epochs,
            batch_size=batch_size,
            patience=patience,
            exploration_noise=exploration_noise,
            metrics_writer=metrics_writer,
            overlap=overlap,
        )
        logger.info(
            "refinement %d: episode reward %.2f, val loss %.5f",
            i + 1, result["reward_sum"][-1], metrics["val_loss"],
        )
        if proposer is not None:
            bc = proposer.train(handler.replay, epochs=bc_epochs)
            if metrics_writer is not None:
                metrics_writer.scalar("proposer/bc_loss", bc["bc_loss"], i + 1)
        _checkpoint(i + 1)
    return handler, policy


def _make_proposer(env, handler: DynamicsHandler, resume_dir: Optional[str], bc_epochs: int,
                   bc_hidden: tuple, seed: int):
    """The loop's proposer: restored from ``resume_dir`` (an earlier port's payload
    ``proposer/proposer.pt``, else the Orbax ``proposer/``, else the JAX package's legacy
    ``proposer.npy``) or behaviour-cloned on the bootstrap replay."""
    from blackbox_mpc_torch.core.types import Bounds
    from blackbox_mpc_torch.learning.orbax_read import restore_pytree
    from blackbox_mpc_torch.learning.proposer import PolicyProposer, ProposerConfig
    from blackbox_mpc_torch.models.convert import load_legacy_npy, proposer_from_numpy

    if handler.replay is None:
        raise ValueError(
            "behavior_cloning=True requires a learned-dynamics handler (a replay "
            "buffer to clone from); true-model handlers have none"
        )
    config = ProposerConfig(dim_s=handler.config.dim_s, dim_u=env.action_space.dim,
                            hidden=bc_hidden)
    bounds = Bounds.from_space(env.action_space)
    proposer = PolicyProposer(config, bounds, seed=seed, device=handler.device)
    orbax = os.path.join(resume_dir, _PROPOSER_TREE) if resume_dir else None
    payload = os.path.join(orbax, _PROPOSER_PAYLOAD) if resume_dir else None
    legacy = os.path.join(resume_dir, "proposer.npy") if resume_dir else None
    if payload and os.path.exists(payload):
        proposer.load_state_dict(torch.load(payload, map_location=handler.device))
        logger.info("resumed proposer from %s", payload)
    elif orbax and os.path.exists(os.path.join(orbax, "_METADATA")):
        restored = proposer_from_numpy(restore_pytree(orbax), config, bounds,
                                       device=handler.device)
        proposer.load_state_dict(restored.state_dict())
        logger.info("resumed proposer from %s", orbax)
    elif legacy and os.path.exists(legacy):
        restored = proposer_from_numpy(load_legacy_npy(legacy), config, bounds,
                                       device=handler.device)
        proposer.load_state_dict(restored.state_dict())
        logger.info("resumed proposer from legacy %s", legacy)
    else:
        logger.info("behavior cloning: %s", proposer.train(handler.replay, epochs=bc_epochs))
    return proposer
