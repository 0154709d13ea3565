"""Standalone serving runtime for exported MPC policy artifacts.

Counterpart of ``blackbox_mpc_tpu/deploy/serving.py``. This module is **self-contained**: it
imports only the standard library, numpy and torch, never the rest of ``blackbox_mpc_torch``.
Copy this one file into a serving container together with a ``.bbmpc`` artifact written by
:func:`blackbox_mpc_torch.deploy.export_policy_artifact` and it runs the whole MPC control
step (solver iterations, rollouts, exploration noise, one-step lookahead) without the package
or its solver code: the artifact carries the step as a ``torch.export`` program.

Artifact layout (one zip file, conventional suffix ``.bbmpc``), the JAX package's with
``torch.export`` programs in place of ``*.jaxexport``::

    meta.json            solver, shapes, the generator algorithm, the draws (format_version 1,
                         2 for a sharded artifact)
    <device>/step.pt2    the solve step for one device type ("cuda", "cpu"), torch.export.save
    <device>/reset.pt2   the per-episode solver-state reset for that device type (none for
                         a solver without state)
    state/...            solver-state leaves (manifest.json + <i>.bin raw tensors)
    params/...           dynamics-parameter leaves (none for a true model)
    proposer/...         proposer-parameter leaves (none without a proposer)
    key/...              the exporting policy's generator states: the solver's, then the
                         rollout noise's (the stream's resume point)

**Sharded artifacts** (format 2, JAX's topology pin): the program of one rank of a policy
sharded over ``meta["nr_devices"]`` ranks, with its collectives inside, recorded by the name of
their process group (``meta["process_group"]``). It is served by a ``torch.distributed`` world
of that many ranks in which the group of that name exists (the default group is ``"0"``), each
rank loading the artifact of its own rank; :meth:`ServingPolicy.load` refuses another world.

Tensors are raw little-endian bytes plus a manifest of shapes and dtype names, the layout of
the JAX package's ``pack_tensors`` (bfloat16 goes by its name), so a group packed by one
package is read by the other.

**The random stream.** ``torch.export`` would turn a generator the step draws from into a
constant of the program, out of reach of ``reset``/``reseed``. So the programs draw nothing:
every random tensor of the step is an input, listed in ``meta["draws"]`` (which generator,
which function, its arguments), and :class:`ServingPolicy` draws them from generators of its
own, in the order and with the calls the exporting ``MPCPolicy`` makes. Its stream then
advances exactly as the policy's does: the exploration noise is drawn only when ``act`` is
asked for it, and the rollout noise of sampled propagation is drawn from the noise
generator's state at the start of the step for every evaluation (common random numbers), as
``MPCPolicy`` does.

**The compiled cache** (the JAX package's XLA executable cache, read for PyTorch). A loaded
artifact runs its ``torch.export`` graphs op by op from Python. :meth:`ServingPolicy.precompile`
compiles the step and reset programs for the serving device with AOTInductor
(``torch._inductor.aoti_compile_and_package``); :meth:`ServingPolicy.save_compiled` writes
those packages into one cache file (a zip of ``fingerprint.json``, ``step.pt2`` and
``reset.pt2``), and ``ServingPolicy.load(..., compiled_cache=path)`` loads them and compiles
nothing. The fingerprint pins the cache to the torch and CUDA versions, the device kind and
the artifact's programs (``program_hash``); a missing, corrupt or stale cache is ignored with a
``RuntimeWarning`` and the uncompiled program serves. The draws stay inputs of the compiled
programs, so the stream is the same. The compiled code is loaded as a shared library: treat a
cache with the same trust as the artifact itself.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import warnings
import zipfile
from collections.abc import Mapping
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["ServingPolicy", "pack_tensors", "unpack_tensors", "tree_leaves", "write_artifact",
           "FORMAT_VERSION", "SHARDED_FORMAT_VERSION", "SUPPORTED_FORMAT_VERSIONS"]

# Version 1: single-device artifacts. Version 2: topology-pinned sharded ones, whose programs
# hold collectives (every policy sharded over nr_devices > 1 ranks, and one over a 1-rank
# process group), stamped apart so that a loader from before sharding refuses them at the
# version gate, as in the JAX package. Single-device artifacts stay version 1.
FORMAT_VERSION = 1
SHARDED_FORMAT_VERSION = 2
SUPPORTED_FORMAT_VERSIONS = (1, 2)
# The generator algorithm of each device type (what JAX's rng_impl names).
RNG_IMPLS = {"cuda": "philox4x32-10", "cpu": "mt19937"}
# The random functions a step may draw through, and the generators it draws from.
DRAW_FUNCTIONS = ("rand", "randn", "randint")
GENERATORS = ("solver", "noise")
# MPCPolicy seeds its rollout-noise generator this far from the solver's.
NOISE_SEED_OFFSET = 0x5EED
# The programs of an artifact, and the members of a compiled cache beside its fingerprint.
PROGRAMS = ("step", "reset")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _as_cpu(leaf) -> torch.Tensor:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def pack_tensors(zf: zipfile.ZipFile, group: str, leaves: Sequence[Any]) -> None:
    """Writes flat tensor (or array) leaves as ``<group>/manifest.json`` + ``<group>/<i>.bin``."""
    manifest = []
    for i, leaf in enumerate(leaves):
        t = _as_cpu(leaf)
        manifest.append({"shape": list(t.shape), "dtype": _dtype_name(t.dtype)})
        zf.writestr(f"{group}/{i}.bin", t.reshape(-1).view(torch.uint8).numpy().tobytes())
    zf.writestr(f"{group}/manifest.json", json.dumps(manifest))


def unpack_tensors(zf: zipfile.ZipFile, group: str) -> list[torch.Tensor]:
    """The leaves of ``group`` as CPU tensors."""
    manifest = json.loads(zf.read(f"{group}/manifest.json"))
    leaves = []
    for i, spec in enumerate(manifest):
        dtype = getattr(torch, spec["dtype"])
        buf = zf.read(f"{group}/{i}.bin")
        flat = (torch.frombuffer(bytearray(buf), dtype=torch.uint8).view(dtype) if buf
                else torch.empty(0, dtype=dtype))
        leaves.append(flat.reshape(spec["shape"]).clone())
    return leaves


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in a fixed order: dataclass fields in declaration order,
    mapping values by sorted key (as ``jax.tree`` orders a dict), sequences in order; other
    values (None, Python scalars) hold no leaf."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return []


def _resolve_device(device) -> torch.device:
    """None -> ``cuda``, as every entry point of the package (a copy of its
    ``core/device.py::resolve_device``, which this module may not import)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_world(meta: dict) -> None:
    """A sharded artifact needs a world of ``nr_devices`` ranks, this one its exporter's."""
    if meta.get("process_group") is None:  # no collectives in the program
        return
    nr = int(meta["nr_devices"])
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world != nr:
        raise ValueError(
            f"artifact is topology-pinned to {nr} ranks (mesh_axes={meta.get('mesh_axes')}), "
            f"but this runtime's torch.distributed world has {world}")
    if dist.get_rank() != meta["rank"]:
        raise ValueError(f"this artifact holds rank {meta['rank']}'s program; this process is "
                         f"rank {dist.get_rank()}: load that rank's artifact")


def _device_kind(device: torch.device) -> dict:
    """What a compiled package is pinned to on ``device``: the card's name and compute
    capability, or the CPU's vector instruction set."""
    if device.type == "cuda":
        return {"device_kind": torch.cuda.get_device_name(device),
                "capability": list(torch.cuda.get_device_capability(device))}
    return {"device_kind": torch.backends.cpu.get_cpu_capability()}


def _compile_package(program) -> bytes:
    """An AOTInductor package of ``program`` (an ``ExportedProgram``), as bytes."""
    buf = io.BytesIO()
    torch._inductor.aoti_compile_and_package(program, package_path=buf)
    return buf.getvalue()


def _load_package(data: bytes, device: torch.device):
    """The runner of an AOTInductor package: called as the program's module is."""
    index = device.index if device.type == "cuda" else -1
    return torch._inductor.aoti_load_package(io.BytesIO(data), device_index=index)


class ServingPolicy:
    """Loads a ``.bbmpc`` artifact and serves ``act()`` / ``reset()`` from it.

    The behavioral contract matches ``MPCPolicy``: ``act`` accepts an unbatched ``[S]``
    observation (tiled across agents) or a batched ``[num_agents, S]`` array and returns
    ``(action, predicted_next_obs, predicted_reward)``, un-batched iff the input was. The
    artifact holds the exporting policy's solver state and generator states, so a loaded
    ServingPolicy on the same device type continues bit for bit where that ``MPCPolicy``
    stood.
    """

    def __init__(self, meta: dict, programs: dict, state, params, proposer, key_states,
                 device: torch.device, seed: int | None = None,
                 compiled_cache: str | None = None) -> None:
        self.meta = dict(meta)
        self._num_agents = int(meta["num_agents"])
        self._dim_s = int(meta["dim_s"])
        self._device = device
        # {"step": bytes, "reset": bytes or None}: the artifact's torch.export programs for
        # this device type, deserialized only where they run (op by op) or are compiled.
        self._program_bytes = programs
        self._program_hash = hashlib.sha256(
            b"".join(b for b in programs.values() if b is not None)).hexdigest()
        self._programs = None
        self._packages = None  # the AOTInductor packages, once compiled or loaded
        self.used_compiled_cache = False
        if compiled_cache is not None:
            self._load_compiled_cache(compiled_cache)
        if self._packages is None:
            self._step, self._reset = (None if p is None else p.module()
                                       for p in self._exported().values())
        self._draws = meta["draws"]
        put = lambda leaves: tuple(t.to(device) for t in leaves)  # noqa: E731
        self._state = put(state)
        self._params = put(params)
        self._proposer = put(proposer)
        self._generators = {name: torch.Generator(device=device) for name in GENERATORS}
        if seed is not None:
            self.reseed(seed)
        elif RNG_IMPLS.get(device.type) != meta["rng_impl"]:
            raise ValueError(
                f"the artifact's stream is {meta['rng_impl']!r} (exported on "
                f"{meta['stream_device']}); {device.type} generators run "
                f"{RNG_IMPLS.get(device.type)!r}, so the stream cannot continue here: pass "
                "seed= to start a fresh one")
        else:
            for name, state_bytes in zip(GENERATORS, key_states):
                self._generators[name].set_state(state_bytes)
        # The exploration noise's inputs when act() is not asked for it: zeros, drawn never.
        self._no_explore = tuple(self._zeros(spec) for spec in self._draws["explore"])
        # act()'s flag, both values on the device once: a copy in at every act() would make
        # the host wait.
        self._explore_flags = {flag: torch.tensor(flag, device=device) for flag in (False, True)}
        self._last_plan = None
        self._last_expected_reward = None

    # ------------------------------------------------------------------ construction

    @classmethod
    def load(cls, path: str, compiled_cache: str | None = None, device=None, *,
             seed: int | None = None) -> "ServingPolicy":
        """Loads an artifact onto ``device`` (None: ``cuda``), whose type must be one of the
        artifact's ``platforms``; ``path`` and ``compiled_cache`` come first, in JAX's order.
        ``seed`` starts a fresh stream (see :meth:`reseed`) in place of the stored one, which
        only a device of the exporting type can continue.
        ``compiled_cache``: a file written by :meth:`save_compiled`; when its fingerprint
        matches this runtime and artifact, the compiled programs serve from the first ``act``
        and nothing is compiled (``used_compiled_cache`` is True). Otherwise it is ignored with
        a ``RuntimeWarning`` and the uncompiled programs serve."""
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("meta.json"))
            if meta.get("format_version") not in SUPPORTED_FORMAT_VERSIONS:
                raise ValueError(
                    f"artifact format_version {meta.get('format_version')} not in "
                    f"supported {SUPPORTED_FORMAT_VERSIONS}"
                )
            _check_world(meta)
            kind = torch.device("cuda" if device is None else device).type
            if kind not in meta["platforms"]:
                raise ValueError(f"the artifact has programs for {meta['platforms']}, not "
                                 f"{kind}: export it with platforms including {kind!r}")
            dev = _resolve_device(device)
            programs = {name: zf.read(f"{kind}/{name}.pt2")
                        if f"{kind}/{name}.pt2" in zf.namelist() else None
                        for name in PROGRAMS}
            groups = [unpack_tensors(zf, g) for g in ("state", "params", "proposer", "key")]
        return cls(meta, programs, *groups, device=dev, seed=seed, compiled_cache=compiled_cache)

    # ------------------------------------------------------------------ compiled cache

    def _fingerprint(self) -> dict:
        """The validity domain of a compiled cache: the torch and CUDA versions and the
        device kind the packages were compiled for, and, through ``program_hash`` (sha256 of
        the artifact's step and reset programs for this device type), the programs they were
        compiled from, so a cache saved against one artifact is refused after a re-export
        with other settings."""
        return {
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": self._device.type,
            **_device_kind(self._device),
            "solver_name": self.meta["solver_name"],
            "num_agents": self._num_agents,
            "dim_s": self._dim_s,
            "nr_devices": int(self.meta.get("nr_devices", 1)),
            "rank": self.meta.get("rank"),
            "program_hash": self._program_hash,
        }

    def _exported(self) -> dict:
        """``{"step": ExportedProgram, "reset": ExportedProgram or None}``."""
        if self._programs is None:
            self._programs = {name: None if data is None
                              else torch.export.load(io.BytesIO(data))
                              for name, data in self._program_bytes.items()}
        return self._programs

    def _use_packages(self, packages: dict) -> None:
        runners = {name: None if data is None else _load_package(data, self._device)
                   for name, data in packages.items()}
        self._step, self._reset = runners["step"], runners["reset"]
        self._packages = packages

    def precompile(self) -> "ServingPolicy":
        """Compiles the step and reset programs for this device with AOTInductor now, and
        serves through them from here on (a no-op once compiled or loaded from a cache).
        A sharded (format 2) program keeps its collectives, which run on the process group
        of the artifact's name, so each rank compiles and caches its own. Returns ``self``."""
        if self._packages is None:
            self._use_packages({name: None if p is None else _compile_package(p)
                                for name, p in self._exported().items()})
        return self

    def save_compiled(self, path: str) -> None:
        """Precompiles, then writes the compiled cache to ``path``: a zip of
        ``fingerprint.json``, ``step.pt2`` and ``reset.pt2`` (the AOTInductor packages). A
        later ``ServingPolicy.load(artifact, compiled_cache=path)`` with the same torch, CUDA
        and device kind starts serving with no compile. The file is published atomically."""
        if self.used_compiled_cache:
            raise RuntimeError(
                "this ServingPolicy was itself loaded from a compiled cache; the cache "
                "file already exists: copy it instead of writing it again")
        self.precompile()
        tmp = f"{path}.tmp.{os.getpid()}"
        with zipfile.ZipFile(tmp, "w") as zf:
            zf.writestr("fingerprint.json", json.dumps(self._fingerprint()))
            for name, data in self._packages.items():
                if data is not None:
                    zf.writestr(f"{name}.pt2", data)
        os.replace(tmp, path)

    def _load_compiled_cache(self, path: str) -> None:
        try:
            with zipfile.ZipFile(path) as zf:
                got, want = json.loads(zf.read("fingerprint.json")), self._fingerprint()
                if got != want:
                    raise ValueError(f"compiled cache fingerprint {got} != this runtime's "
                                     f"{want}")
                packages = {name: None if data is None else zf.read(f"{name}.pt2")
                            for name, data in self._program_bytes.items()}
            self._use_packages(packages)
            self.used_compiled_cache = True
        except Exception as e:  # noqa: BLE001 - a stale cache must never block serving
            warnings.warn(f"ignoring compiled cache {path!r} ({type(e).__name__}: {e}); "
                          "serving the uncompiled program", RuntimeWarning, stacklevel=4)

    # ------------------------------------------------------------------ the stream

    def _zeros(self, spec) -> torch.Tensor:
        return torch.zeros(spec["shape"], dtype=getattr(torch, spec["dtype"]),
                           device=self._device)

    def _draw(self, specs, noise_start=None) -> tuple:
        """The random inputs of one program call, drawn as the exporting policy draws them;
        every draw of the noise generator starts from ``noise_start``."""
        out = []
        for spec in specs:
            generator = self._generators[spec["generator"]]
            if spec["generator"] == "noise":
                generator.set_state(noise_start)
            fn = getattr(torch, spec["fn"])
            out.append(fn(*spec["args"], generator=generator, device=self._device,
                          dtype=getattr(torch, spec["dtype"])))
        return tuple(out)

    def _step_index(self, t: int) -> torch.Tensor:
        """``t`` as the program's int64 input; on CUDA copied from pinned memory, so the host
        does not wait for the device."""
        host = torch.tensor(int(t), dtype=torch.int64)
        if self._device.type == "cuda":
            return host.pin_memory().to(self._device, non_blocking=True)
        return host.to(self._device)

    # ------------------------------------------------------------------ public API

    @property
    def solver_name(self) -> str:
        return self.meta["solver_name"]

    @property
    def num_agents(self) -> int:
        return self._num_agents

    @property
    def device(self) -> torch.device:
        return self._device

    @torch.no_grad()
    def act(self, observations, t: int = 0, exploration_noise: bool = False):
        obs = np.asarray(observations, dtype=np.float32)
        batched = obs.ndim > 1
        if not batched:
            obs = np.tile(obs[None], (self._num_agents, 1))
        if obs.shape != (self._num_agents, self._dim_s):
            raise ValueError(
                f"observations shape {obs.shape} != ({self._num_agents}, {self._dim_s})"
            )
        noise_start = self._generators["noise"].get_state()
        draws = self._draw(self._draws["step"], noise_start)
        explore = bool(exploration_noise)
        noise = self._draw(self._draws["explore"]) if explore else self._no_explore
        action, self._state, expected, plan, next_obs, reward = self._step(
            self._state, self._params, self._proposer, torch.as_tensor(obs, device=self._device),
            self._step_index(t), self._explore_flags[explore], draws, noise,
        )
        self._last_plan, self._last_expected_reward = plan, expected
        flat = torch.cat([action.reshape(-1), next_obs.reshape(-1), reward.reshape(-1)])
        flat = flat.float().cpu().numpy()
        n_a, n_o = action.numel(), next_obs.numel()
        action = flat[:n_a].reshape(action.shape)
        next_obs = flat[n_a:n_a + n_o].reshape(next_obs.shape)
        reward = flat[n_a + n_o:].reshape(reward.shape)
        if batched:
            return action, next_obs, reward
        return action[0], next_obs[0], reward[0]

    def plan(self):
        """The last solve's refined plan ``[A, H, U]`` and expected reward ``[A]`` (None
        before the first ``act``)."""
        if self._last_plan is None:
            return None, None
        return self._last_plan.cpu().numpy(), self._last_expected_reward.cpu().numpy()

    @torch.no_grad()
    def reset(self) -> None:
        """Per-episode solver-state reset, mirroring ``MPCPolicy.reset`` (a solver without
        state has no reset program)."""
        if self._reset is not None:
            self._state = self._reset(self._state, self._draw(self._draws["reset"]))

    def reseed(self, seed: int) -> None:
        """Replaces the stored stream with a fresh one, the streams of an ``MPCPolicy`` built
        with ``seed``: the solver's generator seeded with ``seed``, the rollout noise's with
        ``seed + 0x5EED``."""
        self._generators["solver"].manual_seed(seed)
        self._generators["noise"].manual_seed(seed + NOISE_SEED_OFFSET)

    def update_dynamics_params(self, params) -> None:
        """Swaps the dynamics parameters without re-exporting.

        Accepts a parameter tree (e.g. a freshly trained ``DynamicsHandler.dynamics_params``)
        or a flat leaf sequence; the leaf count, shapes and dtypes must match the exported
        ones, for which the program was traced.
        """
        leaves = (list(params) if isinstance(params, (list, tuple))
                  and all(torch.is_tensor(x) or isinstance(x, np.ndarray) for x in params)
                  else tree_leaves(params))
        if len(leaves) != len(self._params):
            raise ValueError(
                f"got {len(leaves)} parameter leaves, artifact expects {len(self._params)}"
            )
        new = []
        for i, (got, want) in enumerate(zip(leaves, self._params)):
            t = got if torch.is_tensor(got) else torch.from_numpy(np.asarray(got))
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(
                    f"parameter leaf {i}: got {tuple(t.shape)}/{t.dtype}, artifact expects "
                    f"{tuple(want.shape)}/{want.dtype}"
                )
            new.append(t.detach().to(self._device).clone())
        self._params = tuple(new)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ServingPolicy(solver={self.meta['solver_name']!r}, "
            f"agents={self._num_agents}, horizon={self.meta['planning_horizon']}, "
            f"device={self._device}, compiled={self._packages is not None})"
        )


def write_artifact(path: str, meta: dict, programs: dict, state_leaves, params_leaves,
                   proposer_leaves, key_states) -> None:
    """Writes the zip layout of the module docstring; ``programs`` maps each device type to
    its ``(step bytes, reset bytes or None)``. Lives here so that the format's reader and
    writer stay in one self-contained file."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        version = (FORMAT_VERSION if meta.get("process_group") is None
                   else SHARDED_FORMAT_VERSION)
        zf.writestr("meta.json", json.dumps({**meta, "format_version": version}))
        for kind, (step_bytes, reset_bytes) in programs.items():
            zf.writestr(f"{kind}/step.pt2", step_bytes)
            if reset_bytes is not None:
                zf.writestr(f"{kind}/reset.pt2", reset_bytes)
        pack_tensors(zf, "state", state_leaves)
        pack_tensors(zf, "params", params_leaves)
        pack_tensors(zf, "proposer", proposer_leaves)
        pack_tensors(zf, "key", key_states)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
