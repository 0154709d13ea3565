"""Export of MPC policies and dynamics models as ``torch.export`` programs.

Counterpart of ``blackbox_mpc_tpu/deploy/export.py``. :func:`export_policy_artifact` writes the
whole policy step (solver iterations, trajectory rollouts, exploration noise, one-step
lookahead) into one ``.bbmpc`` file that
:class:`~blackbox_mpc_torch.deploy.serving.ServingPolicy` (a self-contained module) loads and
runs without the package.

The exported step's signature (flat tensor tuples only, so the loader needs no classes of
the package), JAX's with the random stream as inputs::

    step(state_leaves, params_leaves, proposer_leaves, obs [A, S] f32, t i64, explore bool,
         draws, explore_draws)
      -> (action [A, U], new_state_leaves, expected_reward [A], plan [A, H, U],
          predicted_next_obs [A, S], predicted_reward [A])

``draws`` are the step's random tensors and ``explore_draws`` the exploration noise's, in the
order ``MPCPolicy`` draws them (``meta["draws"]``; serving.py explains why the program draws
nothing itself). ``explore`` selects the noisy action, as JAX's traced boolean does; the
loader draws ``explore_draws`` only when asked for the noise, so the stream advances as the
policy's does for either value.

Scope, as in JAX: the ``"eager"`` backend. The CUDA kernels of ``"kernel"``/``"fused"`` are
``ctypes`` calls that ``torch.export`` cannot capture, as JAX's Mosaic custom calls are not
portable StableHLO; those policies raise here.

A policy sharded over a mesh of D > 1 ranks exports with its collectives in the program (the
functional collectives of ``parallel/mesh.py``, recorded with their process group's name), so
the artifact is topology-pinned, JAX's format 2: ``meta["nr_devices"]`` is D and
``meta["mesh_axes"]`` is ``{"pop": D}``, beside ``shard_axis``, the group's name and this
rank. The block a rank rolls out depends on its rank, so every rank exports its own artifact
(all ranks call :func:`export_policy_artifact` together: its eager step runs the
collectives), and a world of D ranks serves them, each rank its own. A policy over a process
group of one rank holds the collectives too, and is stamped format 2 as well.
"""
from __future__ import annotations

import copy
import dataclasses
import io
from collections.abc import Mapping
from typing import Optional, Sequence

import torch
from torch.export.passes import move_to_device_pass
from torch.overrides import TorchFunctionMode

from blackbox_mpc_torch.deploy.serving import (
    DRAW_FUNCTIONS,
    GENERATORS,
    tree_leaves,
    write_artifact,
)
from blackbox_mpc_torch.solvers.base import exploration_noise as _exploration_noise

__all__ = ["export_policy_artifact", "export_dynamics"]

_PLATFORMS = ("cuda", "cpu")


def _unflatten(template, leaves):
    """``template`` with its tensor leaves (in :func:`tree_leaves` order) replaced by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            out = copy.copy(node)
            for f in dataclasses.fields(node):
                object.__setattr__(out, f.name, build(getattr(node, f.name)))
            return out
        if isinstance(node, Mapping):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return node

    return build(template)


def _json_args(args):
    out = []
    for a in args:
        if isinstance(a, (tuple, list, torch.Size)):
            out.append(_json_args(a))
        elif isinstance(a, int) and not isinstance(a, bool):
            out.append(int(a))
        else:
            raise ValueError(f"a draw's argument {a!r} is not a static shape or bound: the "
                             "step's random draws must not depend on the data")
    return out


class _Draws(TorchFunctionMode):
    """Intercepts the draws from the step's generators (``{id(generator): name}``).

    Without ``inputs`` it records them (``specs``) and draws for real; with ``inputs`` it
    returns those, in order, in place of the draws, each checked against ``expect``.
    """

    def __init__(self, generators: dict, inputs=None, expect=None):
        super().__init__()
        self.generators = generators
        self.inputs = None if inputs is None else list(inputs)
        self.expect = expect
        self.specs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        generator = kwargs.get("generator")
        if generator is None:
            return func(*args, **kwargs)
        name = self.generators.get(id(generator))
        fn = getattr(func, "__name__", str(func))
        if name is None or fn not in DRAW_FUNCTIONS or any(
                v not in (None, False) for k, v in kwargs.items()
                if k not in ("generator", "device", "dtype")):
            raise ValueError(f"the step draws through torch.{fn} from a generator, which the "
                             f"export cannot make an input of (it knows torch.{DRAW_FUNCTIONS} "
                             "from the policy's generators)")
        spec = {"generator": name, "fn": fn, "args": _json_args(args)}
        if self.inputs is None:
            out = func(*args, **kwargs)
            self.specs.append({**spec, "dtype": str(out.dtype).removeprefix("torch."),
                               "shape": list(out.shape)})
            return out
        i = len(self.specs)
        want = self.expect[i] if i < len(self.expect) else None
        if want is None or {k: want[k] for k in spec} != spec:
            raise ValueError(f"draw {i} of the traced step ({spec}) differs from the eager "
                             f"step's ({want}): the draws must not depend on the data")
        self.specs.append(want)
        return self.inputs[i]


def _draw_inputs(specs, device) -> tuple:
    return tuple(torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]), device=device)
                 for s in specs)


def _program_bytes(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _check_platforms(platforms: Sequence[str]) -> None:
    """Raises ``ValueError`` unless every entry is a device type in ``_PLATFORMS`` that this
    process can use."""
    for kind in platforms:
        if kind not in _PLATFORMS:
            raise ValueError(f"platforms must be among {_PLATFORMS}, got {kind!r}")
        if kind == "cuda" and not torch.cuda.is_available():
            raise ValueError("platforms includes 'cuda' but CUDA is not available here")


class _Step(torch.nn.Module):
    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, *args):
        return self.run(*args)


def export_policy_artifact(
    policy,
    path: str,
    *,
    dim_s: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
) -> dict:
    """Exports ``policy`` (an ``MPCPolicy``) to a ``.bbmpc`` serving artifact at ``path``.

    The artifact holds the policy's current solver state and generator states, so a loaded
    :class:`ServingPolicy` on the same device type continues bit for bit from here. A policy
    sharded over D > 1 ranks writes this rank's program (format 2; see the module docstring):
    every rank calls this together, each with a path of its own.

    ``dim_s``: the observation dimension; required for true-model handlers, inferred from
    the learned-dynamics config otherwise. ``platforms``: the device types to write a
    program for, e.g. ``("cuda", "cpu")``; default: the policy's. Returns the artifact's
    ``meta`` dict.
    """
    if policy.rollout_backend != "eager":
        raise ValueError(
            f"rollout_backend={policy.rollout_backend!r} is not exportable: the CUDA kernels "
            "are ctypes calls that torch.export cannot capture. Build the policy with "
            "rollout_backend='eager' for export."
        )
    handler = policy.dynamics_handler
    if dim_s is None:
        if handler.config is None:
            raise ValueError(
                "dim_s= is required when exporting a true-model policy (learned-dynamics "
                "policies infer it from the handler config)"
            )
        dim_s = int(handler.config.dim_s)
    platforms = tuple(platforms) if platforms else (policy.device.type,)
    _check_platforms(platforms)

    home = policy.device
    mesh = policy.mesh
    state = policy._solver_state
    params = handler.dynamics_params
    prop = None if policy.proposer is None else policy.proposer.params
    leaves = [tuple(tree_leaves(x)) for x in (state, params, prop)]
    time_major = bool(getattr(policy._config, "time_major", False))
    bounds, scale = policy._bounds, policy._noise_scale
    example = (*leaves, torch.zeros((policy._num_agents, dim_s), device=home),
               torch.zeros((), dtype=torch.int64, device=home),
               torch.zeros((), dtype=torch.bool, device=home))
    # Copies of the policy's generators: the export draws from them, never from its own.
    generators = {name: torch.Generator(device=home) for name in GENERATORS}
    for generator, source in zip(generators.values(),
                                 (policy._generator, policy._noise_generator)):
        generator.set_state(source.get_state())
    names = {id(g): name for name, g in generators.items()}

    def functions(specs=None):
        """``(step, reset, record)``: ``step(state, params, prop, obs, t, explore, draws,
        explore_draws)`` and ``reset(state, draws)`` of a solver of their own, whose draws
        ``_Draws`` records into ``record`` (``specs`` None) or replaces by the inputs."""
        cell = [None]
        solver = policy._factory(policy._config, bounds, policy._make_evaluate(
            time_major, "eager", params=lambda: cell[0]))
        record = {}

        def draws_of(part, inputs):
            return _Draws(names, None if specs is None else inputs,
                          None if specs is None else specs[part])

        def step(state_leaves, params_leaves, prop_leaves, obs, t, explore, draws, noise):
            st = _unflatten(state, state_leaves)
            dp = cell[0] = _unflatten(params, params_leaves)
            pp = None if prop is None else _unflatten(prop, prop_leaves)
            with torch.no_grad():
                with draws_of("step", draws) as mode:
                    action, new_state, aux = policy._solve(
                        st, obs, t, generators["solver"], generators["noise"], solver=solver,
                        dynamics_params=dp, proposer_params=pp)
                record["step"] = mode.specs
                with draws_of("explore", noise) as mode:
                    noisy = _exploration_noise(generators["solver"], action, bounds, scale)
                record["explore"] = mode.specs
                chosen = torch.where(explore, noisy, action)
                next_obs, pred_reward = policy._lookahead(dp, obs, chosen)
            return (chosen, tuple(tree_leaves(new_state)), aux.expected_reward, aux.plan,
                    next_obs, pred_reward)

        def reset(state_leaves, draws):
            with torch.no_grad(), draws_of("reset", draws) as mode:
                new_state = solver.reset(_unflatten(state, state_leaves), generators["solver"])
            record["reset"] = mode.specs
            return tuple(tree_leaves(new_state))

        return step, reset, record

    # One eager step and reset record the draws; the programs then take them as inputs. They
    # are traced once, on the policy's device, whose per-device constants the eager step made,
    # and moved to each other device type.
    step, reset, specs = functions()
    step(*example, (), ())
    reset(leaves[0], ())
    step, reset, _ = functions(specs)
    step_program = torch.export.export(_Step(step), (
        *example, _draw_inputs(specs["step"], home), _draw_inputs(specs["explore"], home)),
        strict=False)
    # A solver without state (RandomSearch) resets nothing: no program.
    reset_program = torch.export.export(
        _Step(reset), (leaves[0], _draw_inputs(specs["reset"], home)),
        strict=False) if leaves[0] else None
    programs = {}
    for kind in sorted(platforms, key=lambda k: k != home.type):
        if kind != home.type:
            step_program = move_to_device_pass(step_program, kind)
            if reset_program is not None:
                reset_program = move_to_device_pass(reset_program, kind)
        programs[kind] = (_program_bytes(step_program),
                          None if reset_program is None else _program_bytes(reset_program))
    programs = {kind: programs[kind] for kind in platforms}

    from blackbox_mpc_torch import __version__ as pkg_version

    meta = {
        "solver_name": policy.solver_name,
        "num_agents": int(policy._num_agents),
        "planning_horizon": int(policy._planning_horizon),
        "dim_s": int(dim_s),
        "dim_u": int(bounds.dim),
        "rng_impl": policy._rng_impl,
        "stream_device": home.type,
        "noise_scale": float(scale),
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "package_version": pkg_version,
        "nr_devices": 1 if mesh is None else mesh.size,
        "mesh_axes": None if mesh is None else dict(mesh.shape),
        "draws": specs,
    }
    if mesh is not None and mesh.group is not None:  # the program holds collectives
        meta.update(shard_axis=policy.shard_axis, process_group=mesh.group_name, rank=mesh.rank)
    key_states = [policy._generator.get_state(), policy._noise_generator.get_state()]
    write_artifact(path, meta, programs, leaves[0], leaves[1], leaves[2], key_states)
    return meta


def export_dynamics(handler, path: Optional[str] = None, *,
                    platforms: Optional[Sequence[str]] = None):
    """Exports the learned dynamics model alone, with a polymorphic batch dimension.

    ``(states [b, S], actions [b, U]) -> next_states [b, S]``: normalize -> ensemble-mean MLP
    -> denormalize/integrate, with the weights in the program, callable at any batch size
    ``b >= 1``. Returns the ``torch.export.ExportedProgram``; also writes it to ``path`` when
    given (load with ``torch.export.load(path).module()``).

    ``platforms``: the device types the caller wants, as JAX's ``platforms=`` (checked as
    :func:`export_policy_artifact` checks them); default: the handler's. An
    ``ExportedProgram`` holds one device, so the program is made on the first of them, with
    a copy of the weights moved there; the handler stays where it is.
    """
    if handler.is_true_model:
        raise ValueError("true-model handlers have no learned dynamics to export")
    platforms = tuple(platforms) if platforms else (handler.device.type,)
    _check_platforms(platforms)
    device = torch.device(platforms[0])
    if device.type == handler.device.type:
        device = handler.device
    cfg = handler.config
    params = handler.dynamics_params.to(device)
    predict = handler.mean_dynamics_fn

    class _Predict(torch.nn.Module):
        def forward(self, states, actions):
            return predict(params, states, actions)

    batch = torch.export.Dim("b", min=1)
    example = (torch.zeros((2, cfg.dim_s), device=device),
               torch.zeros((2, cfg.dim_u), device=device))
    with torch.no_grad():
        program = torch.export.export(_Predict(), example, strict=False,
                                      dynamic_shapes=({0: batch}, {0: batch}))
    if path is not None:
        torch.export.save(program, path)
    return program
