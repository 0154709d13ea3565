"""The port's reader of the JAX package's Orbax checkpoints (``learning/_zstd.py``,
``learning/orbax_read.py``) held against zstandard, tensorstore and Orbax, and the entry points
that take a JAX-written directory through it: ``DynamicsHandler.load``, the loop's
``resume=True`` and the command line.

The trees: the three committed ``handler/checkpoint``s and ``ckpt_gradient_bc_300/proposer``
(``benchmarks/``), the JAX-written loop ``tests/torch_fixtures/jax_pendulum_loop`` (its handler
and proposer), and checkpoints that the JAX package's ``DynamicsHandler.save`` writes here.
Bytes, keys and leaves must agree exactly (dtype, shape and bits); one Adam step of a loaded
handler agrees with JAX's within 1e-5, as in ``tests/test_torch_pets_checkpoint.py``.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_torch import DynamicsHandler
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.learning import _zstd
from blackbox_mpc_torch.learning.orbax_read import (
    DirectoryStore,
    OcdbtStore,
    leaf_digests,
    read_zarr2,
    restore_pytree,
)
from blackbox_mpc_torch.learning.trainer import flat_params
from blackbox_mpc_torch.models.analytic import pendulum_reward
from blackbox_mpc_torch.models.convert import (handler_from_numpy, handler_to_numpy,
                                               proposer_to_numpy)
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.workflows import iterative_mpc
from tests.test_torch_cli import _last_json, _run

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures"
LOOP = FIXTURES / "jax_pendulum_loop"
_spec = importlib.util.spec_from_file_location("make_jax_pendulum_loop",
                                               FIXTURES / "make_jax_pendulum_loop.py")
maker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(maker)
DIGESTS = json.loads((FIXTURES / "jax_checkpoint_digests.json").read_text())
COMMITTED = ("ckpt_gradient_bc_300", "ckpt_tsinf_p20", "ckpt_tsinf_p20_lvb")
LEARNING_RATE = 3e-3
STEP_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _zstd_data(kind: str) -> bytes:
    rng = np.random.default_rng(0)
    return {"empty": b"", "random": rng.bytes(100_000),
            "structured": np.arange(300_000, dtype=np.float32).tobytes(),
            "repeated": b"orbax" * 400_000}[kind]


@pytest.mark.parametrize("sized", [True, False], ids=["content_size", "unknown_size"])
@pytest.mark.parametrize("kind", ["empty", "random", "structured", "repeated"])
def test_zstd_matches_zstandard(kind, sized):
    """A frame with its content size decodes in one call; one without (a streaming writer's)
    through the streaming API, over several output buffers for the larger cases."""
    data = _zstd_data(kind)
    compressor = zstandard.ZstdCompressor(level=3, write_content_size=sized)
    if sized:
        frame = compressor.compress(data)
    else:
        stream = compressor.compressobj()
        frame = stream.compress(data) + stream.flush()
        assert zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert _zstd.decompress(frame) == zstandard.ZstdDecompressor().decompressobj().decompress(
        frame) == data


def _stores(directory: Path):
    mine = OcdbtStore(str(directory))
    theirs = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}"}).result()
    return mine, theirs


def _assert_same_store(directory: Path) -> None:
    mine, theirs = _stores(directory)
    keys = sorted(k.decode() for k in theirs.list().result())
    assert mine.keys() == keys
    for key in keys:
        assert mine.read(key) == theirs.read(key).result().value, key


@pytest.mark.parametrize("tree", maker.TREES)
def test_ocdbt_store_matches_tensorstore(tree):
    _assert_same_store(ROOT / tree)


@pytest.mark.parametrize("config", [
    {"compression": None, "max_decoded_node_bytes": 64, "max_inline_value_bytes": 8},
    {"compression": {"id": "zstd", "level": 5}, "max_decoded_node_bytes": 128},
], ids=["interior_nodes_uncompressed", "interior_nodes_zstd"])
def test_ocdbt_store_interior_nodes(tmp_path, config):
    """Stores that tensorstore splits into B-trees of several levels, with inline and stored
    values, written over many versions (so the manifest also holds version tree nodes)."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    for i in range(40):
        kv[f"key{i:03d}/{'x' * (i % 5)}"] = bytes([i]) * (i % 13)
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert manifest["versions"][-1]["root_height"] > 1 and manifest["version_tree_nodes"]
    _assert_same_store(tmp_path)


@pytest.mark.parametrize("tree", maker.TREES)
def test_restore_pytree_matches_orbax_and_digests(tree):
    """Leaf for leaf (dtype, shape, bits) as Orbax restores it, in Orbax's nesting, and as
    ``jax_checkpoint_digests.json`` records it (which ``chip_smoke.py`` reads on the card)."""
    mine, want = restore_pytree(ROOT / tree), maker.orbax_restore(str(ROOT / tree))
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    assert leaf_digests(mine) == leaf_digests(want) == DIGESTS[tree]


def _assert_same_handler(got: DynamicsHandler, want: DynamicsHandler) -> None:
    """Params (trainable and planning), Adam state, step, stats, replay with its RNG and the
    counters, bit for bit."""
    for params in ("train_state", "dynamics_params"):
        for a, b in zip(flat_params(getattr(got, params).params),
                        flat_params(getattr(want, params).params), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    sa, sb = (h.train_state.optimizer.state_dict() for h in (got, want))
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    for f in STATS_FIELDS:
        assert torch.equal(getattr(got.dynamics_params.stats, f),
                           getattr(want.dynamics_params.stats, f))
    ra, rb = got.replay.state_dict(), want.replay.state_dict()
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])
        assert np.asarray(ra[k]).dtype == np.asarray(rb[k]).dtype
    assert got.train_state.step == want.train_state.step
    assert (got._train_calls, got._stats_fitted) == (want._train_calls, want._stats_fitted)
    assert got.config == want.config


def _through_jax_load(directory: Path, jh) -> DynamicsHandler:
    """``handler_from_numpy`` over the JAX package's own ``load``: the path before the port
    read Orbax itself."""
    ts_ = jh._train_state
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return handler_from_numpy(
        meta=json.loads((directory / "config.json").read_text()), params=to_np(ts_.params),
        opt_state=to_np(ts_.opt_state), step=np.asarray(ts_.step),
        stats={f: np.asarray(getattr(jh.dynamics_params.stats, f)) for f in STATS_FIELDS},
        replay=jh.replay.state_dict(), device="cpu", learning_rate=LEARNING_RATE)


def _assert_train_step_matches(th: DynamicsHandler, jh) -> None:
    """One Adam step of both from the restored optimizer state, on one JAX minibatch."""
    s, a, ns = next(jh.replay.minibatches(64, jh.config.ensemble_size))
    jstate = jax.tree_util.tree_map(jnp.asarray, jh._train_state)
    jts, jl = jh._train_step(jstate, jh.dynamics_params.stats, s, a, ns)
    tts, tl = th._train_step(th.train_state, th.dynamics_params.stats,
                             *(torch.as_tensor(x) for x in (s, a, ns)))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=STEP_TOL,
                               atol=STEP_TOL)
    jflat = jax.tree_util.tree_map(np.asarray, jts.params)
    jlist = [layer[k] for layer in (jflat["net"] if isinstance(jflat, dict) else jflat)
             for k in ("w", "b")]
    if isinstance(jflat, dict):
        jlist += [jflat["lv_min"], jflat["lv_max"]]
    for got, want in zip(flat_params(tts.params), jlist, strict=True):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("name", COMMITTED)
def test_handler_load_of_committed_jax_checkpoints(name):
    directory = ROOT / "benchmarks" / name / "handler"
    th = DynamicsHandler.load(str(directory), device="cpu", learning_rate=LEARNING_RATE)
    jh = JHandler.load(str(directory), learning_rate=LEARNING_RATE)
    _assert_same_handler(th, _through_jax_load(directory, jh))


JAX_SAVED = {"deterministic": {}, "probabilistic": {"probabilistic": True},
             "learned_bounds": {"probabilistic": True, "learn_logvar_bounds": True}}


@pytest.fixture(scope="module", params=sorted(JAX_SAVED))
def jax_saved(request, tmp_path_factory):
    """A directory written by the JAX package's ``DynamicsHandler.save`` after one
    ``train()``, and JAX's ``load`` of it."""
    config = JConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2,
                     **JAX_SAVED[request.param])
    rng = np.random.default_rng(1)
    s = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    a = rng.uniform(-1, 1, (300, 1)).astype(np.float32)
    ns = (0.9 * s + 0.2 * a + 0.05 * rng.standard_normal((300, 3))).astype(np.float32)
    jh = JHandler(config=config, learning_rate=LEARNING_RATE, seed=3)
    jh.replay.add_transitions(s, a, ns)
    jh.train(epochs=2, batch_size=64)
    directory = tmp_path_factory.mktemp(request.param) / "handler"
    jh.save(str(directory))
    return directory, JHandler.load(str(directory), learning_rate=LEARNING_RATE)


def test_restore_pytree_on_jax_saved(jax_saved):
    directory, _ = jax_saved
    tree = directory / "checkpoint"
    mine, want = restore_pytree(tree), maker.orbax_restore(str(tree))
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    assert leaf_digests(mine) == leaf_digests(want)


def test_handler_load_on_jax_saved_then_trains_as_jax(jax_saved):
    directory, jh = jax_saved
    th = DynamicsHandler.load(str(directory), device="cpu", learning_rate=LEARNING_RATE)
    _assert_same_handler(th, _through_jax_load(directory, jh))
    _assert_train_step_matches(th, jh)


@pytest.mark.parametrize("tree", [t for t in maker.TREES if t.endswith("handler/checkpoint")])
def test_loaded_handler_in_jax_layout_matches_digests(tree):
    """A JAX handler directory loaded by the port and laid out again as the JAX package
    checkpoints it (``models/convert.py::handler_to_numpy``, phase 12's gate) gives every leaf
    of the Orbax tree bit for bit: nothing is lost or rounded on the way into the port."""
    handler = DynamicsHandler.load(str((ROOT / tree).parent), device="cpu")
    assert leaf_digests(handler_to_numpy(handler)[1]) == DIGESTS[tree]


def test_loop_resumes_jax_directory(tmp_path):
    """``resume=True`` on the JAX-written loop: its handler, its Orbax proposer and its
    counter; the loop then runs one refinement and checkpoints in the JAX package's format,
    replacing the JAX-written trees, and the checkpoint loads back bit for bit."""
    work = tmp_path / "loop"
    shutil.copytree(LOOP, work)
    env = NativePendulumVecEnv(num_envs=2, seed=1, max_episode_steps=10)
    before = DynamicsHandler.load(str(work / "handler"), device="cpu")
    assert leaf_digests(restore_pytree(work / "handler" / "checkpoint")) == DIGESTS[
        "tests/torch_fixtures/jax_pendulum_loop/handler/checkpoint"]
    proposer = iterative_mpc._make_proposer(env, before, str(work), bc_epochs=1,
                                            bc_hidden=(64, 64), seed=0)
    saved = restore_pytree(work / "proposer")
    state = proposer.state_dict()
    for layer, want in zip(state["params"], saved["params"], strict=True):
        for k in ("w", "b"):
            assert torch.equal(layer[k][0], torch.as_tensor(want[k]))
    assert state["adam"]["step"] == int(saved["opt_state"][0]["count"])
    handler, policy = iterative_mpc.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, planning_horizon=8, number_of_refinement_steps=2,
        rollout_horizon=10, epochs=1, batch_size=64, population=32, num_elite=4,
        max_iterations=2, seed=0, checkpoint_dir=str(work), resume=True,
        behavior_cloning=True, bc_epochs=1, device="cpu")
    assert json.loads((work / "loop_state.json").read_text()) == {"completed_refinements": 2}
    assert len(handler.replay) == len(before.replay) + 20
    assert handler._train_calls == before._train_calls + 1
    assert policy.proposer is not None
    assert not (work / "handler" / "checkpoint.pt").exists()
    assert not (work / "proposer" / "proposer.pt").exists()
    assert leaf_digests(restore_pytree(work / "handler" / "checkpoint")) == leaf_digests(
        handler_to_numpy(handler)[1])
    assert leaf_digests(restore_pytree(work / "proposer")) == leaf_digests(
        proposer_to_numpy(policy.proposer))
    _assert_same_handler(DynamicsHandler.load(str(work / "handler"), device="cpu"), handler)


def test_cli_calibrate_on_jax_directory():
    """``calibrate`` on a JAX loop directory (it descends to ``handler/``): exit 0 and the
    JAX command's keys and numbers on the same directory."""
    directory = str(ROOT / "benchmarks" / "ckpt_tsinf_p20_lvb")
    rows = {}
    for package in ("blackbox_mpc_tpu", "blackbox_mpc_torch"):
        proc = _run(["calibrate", *(["--cpu"] if package == "blackbox_mpc_torch" else []),
                     directory], package=package)
        assert proc.returncode == 0, (package, proc.stderr[-800:])
        rows[package] = _last_json(proc.stdout)
    want, got = rows["blackbox_mpc_tpu"], rows["blackbox_mpc_torch"]
    assert set(got) == set(want) and got["val_points"] == want["val_points"]
    assert abs(got["variance_ratio"] - want["variance_ratio"]) <= 2e-4


def test_cli_export_from_jax_directory(tmp_path):
    out = str(tmp_path / "ctrl.bbmpc")
    proc = _run(["export", "--env", "pendulum", "--cpu", "-o", out, "--checkpoint-dir",
                 str(LOOP), "--population", "64", "--planning-horizon", "8",
                 "--iterations", "2"])
    assert proc.returncode == 0, proc.stderr[-800:]
    assert _last_json(proc.stdout)["artifact"] == out and Path(out).stat().st_size > 0


def test_read_zarr2_chunks_fill_and_layouts(tmp_path):
    """zarr v2 as tensorstore writes it beyond what Orbax uses: several chunks with partial
    edge chunks, chunks never written (``fill_value``), "/" separators, no compressor, and a
    checkpoint saved with OCDBT off (one file per key)."""
    cases = [("a", "<f8", [7, 5], [3, 2], "/", None, 1.5),
             ("b", "<i8", [10], [4], ".", {"id": "zstd", "level": 1}, 7),
             ("c", "|u1", [4, 3, 2], [2, 2, 2], ".", None, None),
             ("d", "|b1", [6], [4], "/", {"id": "zstd", "level": 1}, False)]
    rng = np.random.default_rng(2)
    for name, dtype, shape, chunks, sep, compressor, fill in cases:
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/{name}",
                       "metadata": {"dtype": dtype, "shape": shape, "chunks": chunks,
                                    "dimension_separator": sep, "compressor": compressor,
                                    "fill_value": fill, "order": "C"}},
                      create=True).result()
        values = (rng.uniform(0, 100, shape) if dtype != "|b1"
                  else rng.uniform(size=shape) > 0.5).astype(np.dtype(dtype))
        region = tuple(slice(0, max(1, s - c)) for s, c in zip(shape, chunks))
        arr[region] = values[region]  # the last chunks stay unwritten
        got = read_zarr2(DirectoryStore(str(tmp_path)), name)
        want = arr.read().result()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "n": [np.int32(3), None]}
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ckptr.save(str(tmp_path / "plain"), tree)
    assert leaf_digests(restore_pytree(tmp_path / "plain")) == leaf_digests(
        maker.orbax_restore(str(tmp_path / "plain")))


def _truncated_manifest(tmp_path):
    work = tmp_path / "tree"
    shutil.copytree(ROOT / maker.TREES[1], work)
    raw = (work / "manifest.ocdbt").read_bytes()
    (work / "manifest.ocdbt").write_bytes(raw[:len(raw) // 2])
    return work


def _flipped_node_byte(tmp_path):
    work = tmp_path / "tree"
    shutil.copytree(ROOT / maker.TREES[1], work)
    node = next((work / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[20] ^= 0xFF
    node.write_bytes(bytes(raw))
    return work


def _dangling_value(tmp_path):
    work = tmp_path / "tree"
    shutil.copytree(ROOT / maker.TREES[1], work)
    for data in (work / "ocdbt.process_0" / "d").iterdir():
        data.write_bytes(b"")
    return work


def _two_processes(tmp_path):
    work = tmp_path / "tree"
    shutil.copytree(ROOT / maker.TREES[1], work)
    shutil.copytree(work / "ocdbt.process_0", work / "ocdbt.process_1")
    return work


def _zarr3(tmp_path):
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))
    ckptr.save(str(tmp_path / "v3"), {"w": np.ones((2, 3), np.float32)})
    return tmp_path / "v3"


@pytest.mark.parametrize("make, error, match", [
    (_truncated_manifest, ValueError, "truncated"),
    (_flipped_node_byte, ValueError, "CRC-32C"),
    (_dangling_value, ValueError, "dangling reference"),
    (_zarr3, ValueError, "zarr v3"),
    (_two_processes, ValueError, "sharded over several"),
], ids=["truncated_manifest", "corrupt_node", "dangling_reference", "zarr_v3",
        "two_processes"])
def test_restore_refuses_what_it_does_not_read(tmp_path, make, error, match):
    with pytest.raises(error, match=match):
        restore_pytree(make(tmp_path))


@pytest.mark.parametrize("frame, match", [
    (b"abcd1234", "not a zstd frame"),
    (zstandard.ZstdCompressor().compress(b"y" * 100_000)[:-10], "zstd"),
], ids=["not_a_frame", "truncated_frame"])
def test_zstd_refuses_bad_frames(frame, match):
    with pytest.raises(ValueError, match=match):
        _zstd.decompress(frame)


def test_zstd_without_the_library_is_an_error(monkeypatch):
    """A missing libzstd raises an error that names it; nothing tries another route."""
    monkeypatch.setattr(_zstd.ctypes.util, "find_library", lambda name: None)
    _zstd._lib.cache_clear()
    try:
        with pytest.raises(OSError, match="libzstd"):
            restore_pytree(ROOT / maker.TREES[1])
    finally:
        monkeypatch.undo()
        _zstd._lib.cache_clear()
