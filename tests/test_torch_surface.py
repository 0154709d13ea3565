"""The port's public surface held to the JAX package's, module by module.

For every public module of ``blackbox_mpc_tpu`` (not ``__main__``, not a module whose name
starts with ``_``, and not ``ops.pallas_rollout``/``ops.pallas_cem``, whose counterparts are
``ops.rollout_kernel``/``ops.fused_cem`` by decision), one case checks each name of its
``__all__`` (or its public functions and classes where it has none) against the module of the
same dotted path in ``blackbox_mpc_torch``:

* the name exists there;
* JAX's positional parameters, in order, are a prefix of the port's, after the renames
  ``key -> generator`` and ``opt_state -> optimizer``;
* a parameter only the port has comes after JAX's (or is keyword-only) and has a default, so
  a call written for JAX binds the same arguments to the same parameters;
* JAX's keyword-only parameters, and its ``*args``/``**kwargs``, exist in the port;
* where JAX has a default, the port's is equal: a JAX dtype equals the torch dtype of its name,
  a dataclass field's factory is compared by calling it, and a ``rollout_backend`` default goes
  through JAX's backend names;
* a class has every public member (methods, properties, dataclass fields) of JAX's class, and
  its constructor and methods pass the checks above.

``EXCEPTIONS`` holds each divergence that is by decision, with its reason (ROADMAP.md, "Not
ported, by decision"). Keys are ``fnmatch`` patterns over the divergence's id:
``<module>.<qualname>`` for a missing name or member, ``<module>.<qualname>:<parameter>`` for a
parameter, with the module where JAX defines the object, relative to the package. A divergence
that no key matches fails and names the module, the function and the parameter; a key that
matches nothing fails too, so the table cannot outlive what it excuses.
"""
import dataclasses
import fnmatch
import importlib
import inspect
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

JAX_PACKAGE, PORT_PACKAGE = "blackbox_mpc_tpu", "blackbox_mpc_torch"
ROOT = Path(__file__).resolve().parents[1]
NAMED_OTHERWISE = {"ops.pallas_rollout", "ops.pallas_cem"}
RENAMES = {"key": "generator", "opt_state": "optimizer"}
BACKEND_NAMES = {"xla": "eager", "pallas": "kernel", "fused_cem": "fused"}

_SHARDING = ("nothing in the port places an array, and parallel/sharding.py reads neither "
             "pop_sharding nor replicated_sharding")
_CONSTANTS = "backend_select's constants carry the port's names, measured on the card"
EXCEPTIONS = {
    "deploy.serving.ServingPolicy.__init__:*":
        "ServingPolicy's constructor takes torch programs; users call ServingPolicy.load",
    "parallel.mesh.make_pop_mesh:*":
        "make_pop_mesh takes a process group and a device, not JAX's devices= list",
    "parallel.mesh.pop_sharding": _SHARDING,
    "parallel.mesh.replicated_sharding": _SHARDING,
    "ops.backend_select.PALLAS_MAX_WIDTH": _CONSTANTS,
    "ops.backend_select.PALLAS_MAX_ROWS": _CONSTANTS,
    "ops.backend_select.FUSED_CEM_MIN_BYTES": _CONSTANTS,
    "ops.pallas_rollout.make_pallas_rollout_evaluator":
        "ops.make_pallas_rollout_evaluator is ops.make_rollout_kernel_evaluator",
    "ops.*:interpret":
        "the Pallas builders' interpret= has no counterpart: a CPU tensor runs a kernel's "
        "plain version",
    "learning.trainer.TrainState.opt_state":
        "TrainState holds a torch.optim.Optimizer where JAX holds opt_state",
    "rollout.evaluator.rollout_trajectories:key":
        "where JAX draws inside with a key the port takes the draw: rollout_trajectories(noise=)",
}


class Divergence(NamedTuple):
    id: str
    message: str


def jax_modules() -> list:
    """The public modules of the JAX package, relative to it ("" is the package)."""
    names = []
    for path in sorted((ROOT / JAX_PACKAGE).rglob("*.py")):
        parts = list(path.relative_to(ROOT / JAX_PACKAGE).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        if any(p.startswith("_") for p in parts):  # __main__ and the private modules
            continue
        name = ".".join(parts)
        if name not in NAMED_OTHERWISE:
            names.append(name)
    return names


def absolute(package: str, rel: str) -> str:
    return f"{package}.{rel}" if rel else package


def public_names(module) -> list:
    names = getattr(module, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(module).items()
            if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__]


def object_id(obj, rel: str, name: str) -> str:
    """Where JAX defines ``obj``, relative to the package, and its qualified name."""
    module = getattr(obj, "__module__", None) or ""
    qualname = getattr(obj, "__qualname__", None)
    if module.startswith(JAX_PACKAGE) and qualname:
        return f"{module[len(JAX_PACKAGE) + 1:]}.{qualname}".lstrip(".")
    return f"{rel}.{name}".lstrip(".")


def signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def field_defaults(cls) -> dict:
    """A dataclass's defaults by field, its factories called."""
    if not (inspect.isclass(cls) and dataclasses.is_dataclass(cls)):
        return {}
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def same_default(name: str, want, got) -> bool:
    if name == "rollout_backend":
        return BACKEND_NAMES.get(want, want) == BACKEND_NAMES.get(got, got)
    if isinstance(got, torch.dtype):  # JAX gives a scalar type or a dtype
        try:
            return np.dtype(want).name == str(got).removeprefix("torch.")
        except TypeError:
            return False
    if callable(want) and callable(got):
        return getattr(want, "__name__", None) == getattr(got, "__name__", None)
    if want is None or got is None or isinstance(want, (str, bool)):
        return want is got or want == got
    try:
        return bool(np.all(np.asarray(want) == np.asarray(got)))
    except (TypeError, ValueError):
        return want == got


def compare_signatures(oid: str, jax_obj, port_obj) -> list:
    js, ts = signature(jax_obj), signature(port_obj)
    if js is None or ts is None:
        return []
    out = []
    jdefaults, tdefaults = field_defaults(jax_obj), field_defaults(port_obj)
    jparams, tparams = list(js.parameters.values()), list(ts.parameters.values())
    jpos = [p for p in jparams if p.kind in _POSITIONAL]
    tpos = [p for p in tparams if p.kind in _POSITIONAL]
    port_names = [q.name for q in tparams]
    for i, p in enumerate(jpos):
        want = RENAMES.get(p.name, p.name)
        if i >= len(tpos) or tpos[i].name != want:
            got = tpos[i].name if i < len(tpos) else "nothing"
            out.append(Divergence(f"{oid}:{p.name}", (
                f"{oid}: JAX's positional parameter {i} is {p.name!r}, the port's is {got!r} "
                f"(port: {port_names})")))
            break
    matched = {RENAMES.get(p.name, p.name) for p in jparams}
    for q in tparams:
        if q.name in matched or q.kind in _VARIADIC:
            continue
        if q.default is inspect.Parameter.empty and q.name not in tdefaults:
            out.append(Divergence(f"{oid}:{q.name}", (
                f"{oid}: the port's parameter {q.name!r} is not JAX's and has no default")))
    by_kind = {q.kind for q in tparams}
    for p in jparams:
        name = RENAMES.get(p.name, p.name)
        if p.kind in _VARIADIC:
            if p.kind not in by_kind:
                out.append(Divergence(f"{oid}:{p.name}",
                                      f"{oid}: JAX takes {p}, the port does not"))
            continue
        q = ts.parameters.get(name)
        if q is None:
            if p.kind == inspect.Parameter.KEYWORD_ONLY:
                out.append(Divergence(f"{oid}:{p.name}", (
                    f"{oid}: JAX's keyword-only parameter {p.name!r} is not the port's "
                    f"(port: {port_names})")))
            continue
        if p.kind == inspect.Parameter.KEYWORD_ONLY and q.kind == inspect.Parameter.POSITIONAL_ONLY:
            out.append(Divergence(f"{oid}:{p.name}",
                                  f"{oid}: {p.name!r} is keyword-only in JAX, positional-only "
                                  "in the port"))
        want = jdefaults.get(p.name, p.default)
        if want is inspect.Parameter.empty:
            continue
        got = tdefaults.get(name, q.default)
        if got is inspect.Parameter.empty or not same_default(p.name, want, got):
            out.append(Divergence(f"{oid}:{p.name}", (
                f"{oid}: {p.name!r} defaults to {want!r} in JAX and to "
                f"{'nothing' if got is inspect.Parameter.empty else repr(got)} in the port")))
    return out


def public_members(cls) -> list:
    names = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return sorted(names)


def has_member(cls, name: str) -> bool:
    if hasattr(cls, name):
        return True
    return dataclasses.is_dataclass(cls) and name in {f.name for f in dataclasses.fields(cls)}


def compare_class(oid: str, jax_cls, port_cls) -> list:
    out = compare_signatures(f"{oid}.__init__", jax_cls, port_cls)
    for name in public_members(jax_cls):
        if not has_member(port_cls, name):
            out.append(Divergence(f"{oid}.{name}",
                                  f"{oid}: JAX's member {name!r} is not the port's"))
            continue
        member = inspect.getattr_static(jax_cls, name, None)
        if isinstance(member, (staticmethod, classmethod)) or inspect.isfunction(member):
            out += compare_signatures(f"{oid}.{name}", getattr(jax_cls, name),
                                      getattr(port_cls, name))
    return out


def divergences(rel: str) -> list:
    jax_module = importlib.import_module(absolute(JAX_PACKAGE, rel))
    port_module = importlib.import_module(absolute(PORT_PACKAGE, rel))
    out = []
    for name in public_names(jax_module):
        jax_obj = getattr(jax_module, name)
        oid = object_id(jax_obj, rel, name)
        if not hasattr(port_module, name):
            out.append(Divergence(oid, f"{port_module.__name__} has no {name!r} ({oid})"))
            continue
        port_obj = getattr(port_module, name)
        if inspect.isclass(jax_obj) and inspect.isclass(port_obj):
            out += compare_class(oid, jax_obj, port_obj)
        elif inspect.isroutine(jax_obj) or (callable(jax_obj) and not inspect.isclass(jax_obj)
                                            and not inspect.ismodule(jax_obj)):
            out += compare_signatures(oid, jax_obj, port_obj)
    return out


def excused(divergence: Divergence) -> bool:
    return any(fnmatch.fnmatchcase(divergence.id, key) for key in EXCEPTIONS)


MODULES = jax_modules()


def test_every_public_module_is_walked():
    assert len(MODULES) >= 55
    assert "" in MODULES and "policies.mpc_policy" in MODULES and "__main__" not in MODULES


@pytest.mark.parametrize("rel", MODULES, ids=lambda rel: rel or JAX_PACKAGE)
def test_module_surface_matches_jax(rel):
    unexcused = [d.message for d in divergences(rel) if not excused(d)]
    assert not unexcused, "\n".join(unexcused)


def test_every_exception_is_needed():
    found = [d for rel in MODULES for d in divergences(rel)]
    unused = [key for key in EXCEPTIONS
              if not any(fnmatch.fnmatchcase(d.id, key) for d in found)]
    assert not unused, unused
