"""The port's writer of the JAX package's checkpoints (``learning/orbax_write.py``,
``models/convert.py::handler_to_numpy``/``proposer_to_numpy``) held against Orbax and the JAX
package.

What the port saves, Orbax's restore, the port's ``restore_pytree`` and the JAX package's
``DynamicsHandler.load`` read leaf for leaf (dtype, shape and bits; the committed digests
``tests/torch_fixtures/jax_checkpoint_digests.json`` for the six committed trees); its
``_METADATA`` and every ``.zarray`` are Orbax's for the same tree (the compressor apart); the
JAX package's loop resumes a loop directory the port wrote, and the port resumes it after that;
a save replaces the whole tree, so a JAX directory the port resumes holds no stale file; a
directory of an earlier port version (``checkpoint.pt``, ``proposer/proposer.pt``) still loads,
and a save over it leaves only the Orbax trees. One-step predictions agree within
``tests/test_torch_learning.py``'s LOSS_RTOL.
"""
import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from blackbox_mpc_tpu.envs import NativePendulumVecEnv as JPendulumEnv
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.learning.proposer import PolicyProposer as JProposer
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.models.analytic import pendulum_reward as j_pendulum_reward
from blackbox_mpc_tpu.workflows import learn_dynamics_iteratively_w_mpc as j_loop
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.learning.orbax_read import leaf_digests, named_leaves, restore_pytree
from blackbox_mpc_torch.learning.orbax_write import save_pytree
from blackbox_mpc_torch.learning.proposer import ProposerConfig
from blackbox_mpc_torch.models.analytic import pendulum_reward
from blackbox_mpc_torch.models.convert import (handler_to_numpy, proposer_from_numpy,
                                               proposer_to_numpy)
from blackbox_mpc_torch.models.dynamics import map_params
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.workflows import iterative_mpc
from tests.test_torch_cli import _last_json, _run
from tests.test_torch_orbax_read import _assert_same_handler

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures"
LOOP = FIXTURES / "jax_pendulum_loop"
_spec = importlib.util.spec_from_file_location("make_jax_pendulum_loop",
                                               FIXTURES / "make_jax_pendulum_loop.py")
maker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(maker)
DIGESTS = json.loads((FIXTURES / "jax_checkpoint_digests.json").read_text())
LEARNING_RATE = 3e-3
LOSS_RTOL = 1e-4  # tests/test_torch_learning.py's, for predict() against JAX's
# One refinement of the loop at test_torch_orbax_read.py's sizes; both packages take these.
RESUME = dict(solver_name="CEM", planning_horizon=8, rollout_horizon=10, epochs=1,
              batch_size=64, population=32, num_elite=4, max_iterations=2, seed=0,
              behavior_cloning=True, bc_epochs=1)
# Files of an OCDBT tree or of the earlier port's payloads: none may be left after a port save.
NOT_WRITTEN = {"manifest.ocdbt", "d", "ocdbt.process_0", "_sharding", "array_metadatas",
               "checkpoint.pt", "proposer.pt"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_adam(opt_state) -> list:
    """optax's ``adam`` state ``(ScaleByAdamState, EmptyState)`` as its Orbax tree holds it."""
    adam = opt_state[0]
    return [{"count": np.asarray(adam.count), "mu": _to_numpy(adam.mu),
             "nu": _to_numpy(adam.nu)}, None]


def _jax_tree(jh) -> dict:
    """A JAX handler's training state in the layout of its Orbax checkpoint, as numpy."""
    ts = jh._train_state
    return {"params": _to_numpy(ts.params), "opt_state": _jax_adam(ts.opt_state),
            "step": np.asarray(ts.step),
            "stats": {f: np.asarray(getattr(jh.dynamics_params.stats, f)) for f in STATS_FIELDS},
            "replay": jh.replay.state_dict()}


def _jax_proposer_tree(state: dict) -> dict:
    return {"params": _to_numpy(state["params"]), "opt_state": _jax_adam(state["opt_state"])}


def _proposer_of(tree: dict, device="cpu"):
    """A port proposer holding the Orbax proposer tree ``tree`` (its widths read from it)."""
    sizes = [layer["w"].shape for layer in tree["params"]]
    dim_u = sizes[-1][1]
    config = ProposerConfig(dim_s=sizes[0][0], dim_u=dim_u,
                            hidden=tuple(s[1] for s in sizes[:-1]))
    return proposer_from_numpy(tree, config, Bounds.of(-1.0, 1.0, dim=dim_u), device=device)


def _files(directory: Path) -> list:
    return sorted(str(p.relative_to(directory)) for p in directory.rglob("*") if p.is_file())


def _resave(tree: str, out: Path) -> Path:
    """The committed tree ``tree`` loaded by the port and saved again by it under ``out``."""
    source = ROOT / tree
    if tree.endswith("handler/checkpoint"):
        DynamicsHandler.load(str(source.parent), device="cpu").save(str(out / "handler"))
        return out / "handler" / "checkpoint"
    save_pytree(str(out / "proposer"), proposer_to_numpy(_proposer_of(restore_pytree(source))))
    return out / "proposer"


@pytest.mark.parametrize("tree", maker.TREES)
def test_port_resave_of_committed_tree_gives_its_digests(tmp_path, tree):
    """JAX -> port -> JAX format: read back by the port's reader and by Orbax's restore, every
    leaf is the committed one, in Orbax's nesting, and no OCDBT file is written."""
    written = _resave(tree, tmp_path)
    assert leaf_digests(restore_pytree(written)) == DIGESTS[tree]
    theirs = maker.orbax_restore(str(written))
    assert leaf_digests(theirs) == DIGESTS[tree]
    assert jax.tree.structure(theirs) == jax.tree.structure(
        maker.orbax_restore(str(ROOT / tree)))
    assert not NOT_WRITTEN & {part for f in _files(written) for part in Path(f).parts}


def _learned_bounds_one_member():
    """A port handler with learned logvar bounds and one member (JAX keeps no [E] axis then),
    after one ``train()``."""
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(8,), ensemble_size=1,
                                   probabilistic=True, learn_logvar_bounds=True)
    return _trained(config)


def _trained(config, seed: int = 3) -> DynamicsHandler:
    rng = np.random.default_rng(1)
    s = rng.uniform(-1, 1, (300, config.dim_s)).astype(np.float32)
    a = rng.uniform(-1, 1, (300, config.dim_u)).astype(np.float32)
    ns = (0.9 * s + 0.2 * a + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    handler = DynamicsHandler(config, learning_rate=LEARNING_RATE, seed=seed, device="cpu")
    handler.replay.add_transitions(s, a, ns)
    handler.train(epochs=2, batch_size=64)
    return handler


TREES_FOR_METADATA = {
    "loop_handler": lambda: handler_to_numpy(
        DynamicsHandler.load(str(LOOP / "handler"), device="cpu"))[1],
    "loop_proposer": lambda: proposer_to_numpy(_proposer_of(restore_pytree(LOOP / "proposer"))),
    "learned_bounds_one_member": lambda: handler_to_numpy(_learned_bounds_one_member())[1],
}


@pytest.mark.parametrize("name", sorted(TREES_FOR_METADATA))
def test_metadata_and_zarrays_are_orbax_own(tmp_path, name):
    """The same numpy tree saved by the port and by Orbax with ``use_ocdbt=False``: the same
    files, ``_METADATA`` equal (its entries in Orbax's order too), ``_CHECKPOINT_METADATA``
    with Orbax's keys, every ``.zarray`` equal apart from ``compressor``."""
    tree = TREES_FOR_METADATA[name]()
    save_pytree(str(tmp_path / "port"), tree)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        str(tmp_path / "orbax"), tree)
    mine, theirs = tmp_path / "port", tmp_path / "orbax"
    assert _files(mine) == _files(theirs)
    meta = [json.loads((d / "_METADATA").read_text()) for d in (mine, theirs)]
    assert meta[0] == meta[1]
    assert list(meta[0]["tree_metadata"]) == list(meta[1]["tree_metadata"])
    info = [json.loads((d / "_CHECKPOINT_METADATA").read_text()) for d in (mine, theirs)]
    assert info[0].keys() == info[1].keys() and info[0]["item_handlers"] == info[1][
        "item_handlers"]
    arrays = [name for name, leaf in named_leaves(tree).items() if leaf is not None]
    assert arrays
    for array in arrays:
        mine_z, theirs_z = (json.loads((d / array / ".zarray").read_text())
                            for d in (mine, theirs))
        assert mine_z.pop("compressor") is None
        theirs_z.pop("compressor")
        assert mine_z == theirs_z, array
    assert leaf_digests(maker.orbax_restore(str(mine))) == leaf_digests(tree)


PORT_TRAINED = {
    "deterministic": dict(hidden=(16, 16), ensemble_size=2),
    "learned_bounds": dict(hidden=(16, 16), ensemble_size=2, probabilistic=True,
                           learn_logvar_bounds=True),
    "one_member": dict(hidden=(16,), ensemble_size=1),
}


@pytest.mark.parametrize("kind", sorted(PORT_TRAINED))
def test_jax_load_reads_what_the_port_trained(tmp_path, kind):
    """After a port ``train()``, the JAX package's ``DynamicsHandler.load`` of the port's
    save holds every leaf bit for bit (params, Adam state, step, stats, replay with its RNG),
    the port's counters, and predicts as the port does."""
    handler = _trained(LearnedDynamicsConfig(dim_s=3, dim_u=1, **PORT_TRAINED[kind]))
    handler.save(str(tmp_path / "handler"))
    assert sorted(os.listdir(tmp_path / "handler")) == ["checkpoint", "config.json"]
    jh = JHandler.load(str(tmp_path / "handler"), learning_rate=LEARNING_RATE)
    assert leaf_digests(_jax_tree(jh)) == leaf_digests(handler_to_numpy(handler)[1])
    assert (jh._train_calls, jh._stats_fitted) == (handler._train_calls, handler._stats_fitted)
    s, a, _ = handler.replay.arrays()
    np.testing.assert_allclose(handler.predict(s[:64], a[:64]).numpy(),
                               np.asarray(jh.predict(s[:64], a[:64])), rtol=LOSS_RTOL,
                               atol=1e-6)


def _copy_loop(tmp_path) -> Path:
    """A copy of the JAX-written loop whose files all carry the time 0."""
    work = tmp_path / "loop"
    shutil.copytree(LOOP, work)
    for path in work.rglob("*"):
        os.utime(path, ns=(0, 0))
    return work


def _port_resume(work: Path, refinements: int):
    env = NativePendulumVecEnv(num_envs=2, seed=1, max_episode_steps=RESUME["rollout_horizon"])
    return iterative_mpc.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_refinement_steps=refinements,
        checkpoint_dir=str(work), resume=True, device="cpu", **RESUME)


def test_resumed_jax_directory_holds_the_port_state_only(tmp_path):
    """The fault of a port that wrote its own payload beside the JAX package's tree: after the
    port resumes a JAX loop directory, every file in it was written by the port's save (none
    older), no payload or OCDBT file is left, and the JAX package's ``load`` and proposer
    restore read the port's weights, Adam state, stats, replay and proposer with its
    counters."""
    work = _copy_loop(tmp_path)
    handler, policy = _port_resume(work, 2)
    files = _files(work)
    assert all((work / f).stat().st_mtime_ns > 0 for f in files), files
    assert not NOT_WRITTEN & {part for f in files for part in Path(f).parts}
    jh = JHandler.load(str(work / "handler"))
    assert leaf_digests(_jax_tree(jh)) == leaf_digests(handler_to_numpy(handler)[1])
    assert jh._train_calls == handler._train_calls == 3
    assert leaf_digests(maker.orbax_restore(str(work / "proposer"))) == leaf_digests(
        proposer_to_numpy(policy.proposer))


def test_loops_resume_each_other(tmp_path, monkeypatch):
    """The JAX-written loop, resumed by the port for one refinement, then by the JAX package's
    loop for one more (it starts at refinement 2 with the port's handler and proposer, leaf for
    leaf), then by the port again, which starts from the JAX package's state."""
    work = _copy_loop(tmp_path)
    port_handler, port_policy = _port_resume(work, 2)
    seen = {}
    j_load, j_load_state = JHandler.load.__func__, JProposer.load_state_dict

    def load(cls, directory, **kwargs):
        jh = j_load(cls, directory, **kwargs)
        seen["handler"] = leaf_digests(_jax_tree(jh))
        return jh

    def load_state_dict(self, state):
        seen["proposer"] = leaf_digests(_jax_proposer_tree(state))
        return j_load_state(self, state)

    monkeypatch.setattr(JHandler, "load", classmethod(load))
    monkeypatch.setattr(JProposer, "load_state_dict", load_state_dict)
    env = JPendulumEnv(num_envs=2, seed=2, max_episode_steps=RESUME["rollout_horizon"])
    jax_handler, jax_policy = j_loop(env, j_pendulum_reward, number_of_refinement_steps=3,
                                     checkpoint_dir=str(work), resume=True, **RESUME)
    monkeypatch.undo()
    assert seen["handler"] == leaf_digests(handler_to_numpy(port_handler)[1])
    assert seen["proposer"] == leaf_digests(proposer_to_numpy(port_policy.proposer))
    assert json.loads((work / "loop_state.json").read_text()) == {"completed_refinements": 3}
    assert jax_handler._train_calls == port_handler._train_calls + 1
    assert len(jax_handler.replay) == len(port_handler.replay) + 20

    resumed = DynamicsHandler.load(str(work / "handler"), device="cpu")
    assert leaf_digests(handler_to_numpy(resumed)[1]) == leaf_digests(_jax_tree(jax_handler))
    proposer = iterative_mpc._make_proposer(NativePendulumVecEnv(num_envs=2), resumed,
                                            str(work), bc_epochs=1, bc_hidden=(64, 64), seed=0)
    assert leaf_digests(proposer_to_numpy(proposer)) == leaf_digests(
        _jax_proposer_tree(jax_policy.proposer.state_dict()))
    handler, _ = _port_resume(work, 4)
    assert json.loads((work / "loop_state.json").read_text()) == {"completed_refinements": 4}
    assert handler._train_calls == jax_handler._train_calls + 1
    assert len(handler.replay) == len(jax_handler.replay) + 20
    assert not NOT_WRITTEN & {part for f in _files(work) for part in Path(f).parts}


def _write_payload(handler, directory: Path) -> None:
    """A handler directory as earlier versions of the port saved it: ``config.json`` and a
    ``torch.save`` payload."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(handler_to_numpy(handler)[0]))
    ts = handler.train_state
    torch.save({"params": map_params(torch.Tensor.detach, ts.params),
                "optimizer": ts.optimizer.state_dict(), "step": ts.step,
                "stats": {f: getattr(handler.dynamics_params.stats, f) for f in STATS_FIELDS},
                "replay": handler.replay.state_dict()}, directory / "checkpoint.pt")


@pytest.mark.parametrize("beside", [None, "jax_tree"], ids=["payload_alone", "beside_jax_tree"])
def test_payload_directory_loads_and_a_save_leaves_only_the_tree(tmp_path, beside):
    """A ``checkpoint.pt`` of an earlier port version loads (it wins over a tree beside it, as
    the earlier port resumed a JAX directory); a save over it leaves ``config.json`` and the
    Orbax tree, which load back bit for bit."""
    directory = tmp_path / "handler"
    if beside:
        shutil.copytree(LOOP / "handler", directory)
    handler = _trained(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(64, 64),
                                             ensemble_size=5))
    _write_payload(handler, directory)
    loaded = DynamicsHandler.load(str(directory), device="cpu", learning_rate=LEARNING_RATE)
    _assert_same_handler(loaded, handler)
    loaded.save(str(directory))
    assert sorted(os.listdir(directory)) == ["checkpoint", "config.json"]
    assert not NOT_WRITTEN & {part for f in _files(directory) for part in Path(f).parts}
    _assert_same_handler(DynamicsHandler.load(str(directory), device="cpu",
                                              learning_rate=LEARNING_RATE), handler)


def test_loop_resumes_a_payload_directory(tmp_path):
    """A loop directory of an earlier port version (``checkpoint.pt`` and
    ``proposer/proposer.pt`` beside the JAX package's stale trees): resume takes the payloads,
    and its checkpoint leaves only the Orbax trees."""
    work = _copy_loop(tmp_path)
    handler = DynamicsHandler.load(str(work / "handler"), device="cpu")
    handler.train(epochs=1, batch_size=64)  # the payloads differ from the stale trees
    _write_payload(handler, work / "handler")
    proposer = _proposer_of(restore_pytree(work / "proposer"))
    proposer.train(handler.replay, epochs=1)
    torch.save(proposer.state_dict(), work / "proposer" / "proposer.pt")
    (work / "loop_state.json").write_text(json.dumps({"completed_refinements": 1}))
    resumed = iterative_mpc._make_proposer(NativePendulumVecEnv(num_envs=2), handler, str(work),
                                           bc_epochs=1, bc_hidden=(64, 64), seed=0)
    assert leaf_digests(proposer_to_numpy(resumed)) == leaf_digests(proposer_to_numpy(proposer))
    after, policy = _port_resume(work, 2)
    assert after._train_calls == handler._train_calls + 1
    assert not NOT_WRITTEN & {part for f in _files(work) for part in Path(f).parts}
    assert leaf_digests(restore_pytree(work / "handler" / "checkpoint")) == leaf_digests(
        handler_to_numpy(after)[1])
    assert leaf_digests(restore_pytree(work / "proposer")) == leaf_digests(
        proposer_to_numpy(policy.proposer))


@pytest.mark.parametrize("bad, error", [
    ({"w": np.ones(3, np.float32), "x": np.zeros((0, 2), np.float32)}, ValueError),
    ({"w": np.ones(3, np.float32), "x": 1.5}, TypeError),
    ({"w": np.ones(3, np.float32), "x": np.array([object()])}, ValueError),
    ({"w": np.ones(3, np.float32), 3: np.ones(1)}, TypeError),
], ids=["zero_size", "python_float", "object_dtype", "int_key"])
def test_failed_save_leaves_the_old_tree_whole(tmp_path, bad, error):
    """A tree the writer refuses raises; the tree it would have replaced reads as before and
    no temporary directory is left beside it."""
    target = tmp_path / "tree"
    old = {"a": [np.arange(4, dtype=np.int64), None], "b": np.float32(2.0) * np.ones((2, 2))}
    save_pytree(str(target), old)
    with pytest.raises(error):
        save_pytree(str(target), bad)
    assert leaf_digests(restore_pytree(target)) == leaf_digests(old)
    assert os.listdir(tmp_path) == ["tree"]


def test_jax_calibrate_on_port_resave(tmp_path):
    """The JAX package's ``calibrate`` on a port re-save of ``ckpt_tsinf_p20_lvb``
    (probabilistic, learned bounds) gives what it gives on the committed directory."""
    committed = ROOT / "benchmarks" / "ckpt_tsinf_p20_lvb"
    DynamicsHandler.load(str(committed / "handler"), device="cpu").save(
        str(tmp_path / "handler"))
    rows = []
    for directory in (committed, tmp_path):
        proc = _run(["calibrate", str(directory)], package="blackbox_mpc_tpu")
        assert proc.returncode == 0, proc.stderr[-800:]
        rows.append(_last_json(proc.stdout))
    want, got = rows
    assert got["val_points"] == want["val_points"]
    assert abs(got["variance_ratio"] - want["variance_ratio"]) <= 2e-4


def test_untrained_handler_saves_optax_fresh_state(tmp_path):
    """A handler saved before its first Adam step (its replay filled, its optimizer fresh, as
    after ``set_params``) holds optax's fresh state, count 0 and zero moments, which the JAX
    package loads; the port loads it and trains on as the fresh handler does."""
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2)
    replay = _trained(config).replay.state_dict()
    fresh = DynamicsHandler(config, learning_rate=LEARNING_RATE, seed=3, device="cpu")
    fresh.replay.load_state_dict(replay)
    fresh.save(str(tmp_path / "handler"))
    jh = JHandler.load(str(tmp_path / "handler"), learning_rate=LEARNING_RATE)
    assert leaf_digests(_jax_tree(jh)) == leaf_digests(handler_to_numpy(fresh)[1])
    adam = _jax_tree(jh)["opt_state"][0]
    assert int(adam["count"]) == 0
    assert not any(np.any(v) for v in named_leaves([adam["mu"], adam["nu"]]).values())
    loaded = DynamicsHandler.load(str(tmp_path / "handler"), device="cpu",
                                  learning_rate=LEARNING_RATE)
    assert loaded.train(epochs=2, batch_size=64) == fresh.train(epochs=2, batch_size=64)


def test_empty_replay_is_refused_as_jax_refuses_it(tmp_path):
    """Orbax writes no array of zero size, so neither package saves a handler whose replay is
    empty; the port raises and writes no file."""
    config = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2)
    with pytest.raises(ValueError, match="zero size"):
        DynamicsHandler(config, device="cpu").save(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="zero size"):
        JHandler(config=JConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2)).save(
            str(tmp_path / "jax"))
    assert not list((tmp_path / "port").iterdir())
