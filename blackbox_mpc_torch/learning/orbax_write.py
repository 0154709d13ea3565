"""Writer of Orbax pytree checkpoints with no JAX, Orbax or tensorstore.

:func:`save_pytree` writes a tree of dicts, lists and numpy arrays in the layout that
``orbax.checkpoint.PyTreeCheckpointHandler(use_ocdbt=False)`` writes, which Orbax's
``PyTreeCheckpointer().restore`` (the JAX package's ``DynamicsHandler.load`` and its loop's
``resume=True``) and :func:`~blackbox_mpc_torch.learning.orbax_read.restore_pytree` read:

- ``_METADATA``: JSON, ``tree_metadata`` with one entry per leaf in the order a JAX pytree
  flattens (dict keys sorted, list items in order), named by ``str`` of its key tuple
  (``"('opt_state', '0', 'count')"``), its ``key_metadata`` (a dict key is ``key_type`` 2, a
  list index 1, as Orbax records optax's tuples) and ``value_metadata``: ``"np.ndarray"``, or
  ``"None"`` with ``skip_deserialize`` for a ``None`` leaf, which has no array. Then
  ``"use_ocdbt": false``, ``"use_zarr3": false``, ``"store_array_data_equal_to_fill_value":
  true`` and ``"custom_metadata": null``.
- ``_CHECKPOINT_METADATA``: JSON with Orbax's keys (the item handler's name, empty metrics,
  the start and commit times in nanoseconds).
- each array leaf, one zarr v2 array named by its dotted key path (``params.0.w``): a
  ``.zarray`` with a single chunk of the whole shape, C order, ``dimension_separator`` ".",
  ``dtype`` numpy's little-endian ``dtype.str``, ``fill_value`` null, no filters, and that
  chunk (``params.0.w/0.0``; ``step/0`` for a 0-d leaf) holding the array's bytes.

The chunks are stored with ``compressor: null``, which Orbax's restore accepts: zstd at
Orbax's level 1 shrinks the arrays of the committed checkpoints (float32 weights and replays)
by 6 to 8 %, and without it the writer needs no compressor. An array of zero size is
refused, as Orbax refuses it.

The tree is built in a temporary sibling of ``directory`` and swapped in with
``os.replace``, so whatever ``directory`` held before (an older tree, an OCDBT
``manifest.ocdbt`` with its ``d/`` and ``ocdbt.process_0/``, ``_sharding``) goes, as with
Orbax's own ``save(..., force=True)``. A failure raises and leaves the old tree whole.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

__all__ = ["save_pytree"]

_SEQUENCE_KEY, _DICT_KEY = 1, 2
_ITEM_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                 "PyTreeCheckpointHandler")


def _flatten(tree, path: tuple = ()) -> list:
    """``[(key path, leaf)]`` in JAX's flattening order, a key path being
    ``((key, key type), ...)``."""
    if isinstance(tree, dict):
        if not tree:
            raise ValueError(f"{_name(path)}: an empty dict is not written")
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"{_name(path)}: dict keys must be str, got "
                            f"{sorted(map(repr, tree))}")
        return [e for k in sorted(tree) for e in _flatten(tree[k], path + ((k, _DICT_KEY),))]
    if isinstance(tree, (list, tuple)):
        if not tree:
            raise ValueError(f"{_name(path)}: an empty sequence is not written")
        return [e for i, v in enumerate(tree)
                for e in _flatten(v, path + ((str(i), _SEQUENCE_KEY),))]
    if tree is not None and not isinstance(tree, np.ndarray):
        raise TypeError(f"{_name(path)}: a leaf must be a numpy array or None, got "
                        f"{type(tree).__name__}")
    return [(path, tree)]


def _name(path: tuple) -> str:
    return ".".join(k for k, _ in path) or "<root>"


def _write_array(directory: str, name: str, leaf: np.ndarray) -> None:
    if leaf.size == 0:
        raise ValueError(f"{name}: an array of zero size is not written (Orbax refuses it)")
    if leaf.dtype.hasobject or leaf.dtype.fields is not None:
        raise ValueError(f"{name}: dtype {leaf.dtype} is not written")
    leaf = leaf.astype(leaf.dtype.newbyteorder("<"), copy=False)  # tobytes() is C order
    shape = list(leaf.shape)
    zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".",
              "dtype": leaf.dtype.str, "fill_value": None, "filters": None, "order": "C",
              "shape": shape, "zarr_format": 2}
    os.mkdir(os.path.join(directory, name))
    with open(os.path.join(directory, name, ".zarray"), "w") as f:
        json.dump(zarray, f, separators=(",", ":"))
    with open(os.path.join(directory, name, ".".join("0" * leaf.ndim) or "0"), "wb") as f:
        f.write(leaf.tobytes())


def _write_tree(directory: str, tree, started_ns: int) -> None:
    entries = {}
    for path, leaf in _flatten(tree):
        name = _name(path)
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            _write_array(directory, name, leaf)
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        entries[str(tuple(k for k, _ in path))] = {
            "key_metadata": [{"key": k, "key_type": kind} for k, kind in path],
            "value_metadata": value}
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _ITEM_HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started_ns,
                   "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)


def save_pytree(directory: str, tree) -> None:
    """Writes ``tree`` (dicts with str keys, lists or tuples, numpy arrays, ``None``) to
    ``directory`` as an Orbax pytree checkpoint without OCDBT, replacing whatever was there
    (see the module's doc)."""
    started_ns = time.time_ns()
    directory = os.path.abspath(directory)
    parent, base = os.path.split(directory)
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(directory) and not os.path.isdir(directory):
        raise NotADirectoryError(f"{directory} exists and is not a directory")
    staged = tempfile.mkdtemp(prefix=f".{base}.tmp-", dir=parent)
    try:
        _write_tree(staged, tree, started_ns)
        if not os.path.isdir(directory):
            os.replace(staged, directory)
            return
        old = f"{staged}.old"  # rename(2) cannot replace a directory that holds files
        os.replace(directory, old)
        try:
            os.replace(staged, directory)
        except BaseException:
            os.replace(old, directory)
            raise
    except BaseException:
        shutil.rmtree(staged, ignore_errors=True)
        raise
    shutil.rmtree(old)
