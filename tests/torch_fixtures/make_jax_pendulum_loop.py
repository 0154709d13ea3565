"""Writes the JAX-written loop directory ``jax_pendulum_loop/`` beside this file and
``jax_checkpoint_digests.json``, the leaf digests of it and of the committed Orbax trees.

The loop is the JAX package's ``learn_dynamics_iteratively_w_mpc`` on the native pendulum
(two envs, 50-step episodes) for one bootstrap rollout and one refinement, with
``checkpoint_dir`` and ``behavior_cloning=True`` (a (64, 64) proposer): a deterministic
(64, 64) tanh, 5-member, f32 ensemble with mean propagation, which the port's kernel backends
accept. The digests give, for each Orbax tree, every leaf's dtype, shape and the SHA-256 of
its bytes as Orbax's own restore (``restore_type=np.ndarray``) returns them, by Orbax's
parameter name. The port's ``chip_smoke.py`` holds its reader to them where there is no JAX.

Run from the repository root, on the CPU: ``python tests/torch_fixtures/make_jax_pendulum_loop.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
LOOP = HERE / "jax_pendulum_loop"
DIGESTS = HERE / "jax_checkpoint_digests.json"
# The Orbax trees the digests cover, relative to the repository's root.
TREES = (
    "benchmarks/ckpt_gradient_bc_300/handler/checkpoint",
    "benchmarks/ckpt_gradient_bc_300/proposer",
    "benchmarks/ckpt_tsinf_p20/handler/checkpoint",
    "benchmarks/ckpt_tsinf_p20_lvb/handler/checkpoint",
    "tests/torch_fixtures/jax_pendulum_loop/handler/checkpoint",
    "tests/torch_fixtures/jax_pendulum_loop/proposer",
)
LOOP_SETTINGS = dict(solver_name="CEM", planning_horizon=15, number_of_initial_rollouts=1,
                     number_of_refinement_steps=1, rollout_horizon=50, epochs=5,
                     batch_size=64, seed=0, behavior_cloning=True, bc_epochs=5,
                     bc_hidden=(64, 64), population=64, num_elite=8, max_iterations=3)


def orbax_restore(directory: str):
    """The tree as Orbax restores it, every leaf a numpy array."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(directory).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    return ckptr.restore(directory, restore_args=args)


def orbax_digests(directory: str) -> dict:
    """``orbax_read.leaf_digests`` of Orbax's own restore of ``directory``."""
    from blackbox_mpc_torch.learning.orbax_read import leaf_digests

    return leaf_digests(orbax_restore(directory))


def write_loop() -> None:
    from blackbox_mpc_tpu.envs import NativePendulumVecEnv
    from blackbox_mpc_tpu.models.analytic import pendulum_reward
    from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig
    from blackbox_mpc_tpu.workflows import learn_dynamics_iteratively_w_mpc

    shutil.rmtree(LOOP, ignore_errors=True)
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64), activation="tanh",
                                   ensemble_size=5, propagation="mean")
    env = NativePendulumVecEnv(num_envs=2, seed=0, max_episode_steps=50)
    learn_dynamics_iteratively_w_mpc(env, pendulum_reward, dynamics_config=config,
                                     checkpoint_dir=str(LOOP), **LOOP_SETTINGS)


def main() -> int:
    sys.path.insert(0, str(ROOT))  # run as a script: the packages live at the root
    write_loop()
    digests = {tree: orbax_digests(str(ROOT / tree)) for tree in TREES}
    DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    size = sum(p.stat().st_size for p in LOOP.rglob("*") if p.is_file())
    print(json.dumps({"loop": str(LOOP.relative_to(ROOT)), "bytes": size,
                      "leaves": {tree: len(d) for tree, d in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
