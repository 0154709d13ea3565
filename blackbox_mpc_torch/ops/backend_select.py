"""Which rollout backend may run a solve, and the measured rule behind
``MPCPolicy(rollout_backend="auto")``: the one account of both.

The backends (``MPCPolicy``'s ``rollout_backend``; the JAX package's names are aliases):

* ``"eager"`` (JAX's ``"xla"``): the eager PyTorch evaluator (``rollout/evaluator.py``),
  replayed as CUDA graphs on the card, sharded over a ``mesh`` (``shard_axis`` ``"population"``
  or ``"agents"``). It runs everything: true models, PETS' probabilistic heads with ``ts_inf``
  and ``mm`` propagation, pessimistic planning (``plan_uncertainty_penalty``), the first-order
  solvers (Gradient, CEM-GD: they differentiate through the rollout) and the time-major
  layout. A latent world model (``models/latent.py``, TD-MPC2's) plans here on one device
  only: the sharded evaluator has no terminal value.
* ``"kernel"`` (JAX's ``"pallas"``): the hand-written CUDA rollout kernel K2
  (``ops/rollout_kernel.py``) under the eager sampler, so its sampling law is eager's.
  Learned MLP ensembles with mean/ts1 propagation, and PETS' ``ts_inf`` (a Gaussian head
  sampled at every step, with swish layers too, in float32; the policy draws the noise as
  eager does). Not: true or latent models, ``mm``, the penalty, a mesh (K2 is single-device),
  the first-order solvers (K2 has no backward), the time-major layout.
* ``"fused"`` (alias ``"fused_cem"``): the generate-in-kernel solver family
  (``ops/fused_cem.py``, over a mesh ``ops/fused_sharded.py``): CEM (with the iCEM options),
  PI2, MPPI, RandomSearch and CMA-ES with ``diagonal=True``. Its kernels draw, roll out and
  reduce the candidates without storing them, deterministically, and sum undiscounted
  rewards: learned MLP ensembles with mean/ts1 propagation, ``discount=1.0``, no smoothness
  cost, a mesh only over the population axis, the layout ``[P, A, H, U]``.

Each refusal is written once, as a rule of :data:`_RULES` (a predicate on the solve and its
message, in the order they are checked); :func:`resolve_backend` raises the first rule of the
requested backend that fires, and :func:`choose_backend` reads the same rules. The kernels'
own input guard (:func:`~blackbox_mpc_torch.ops._kernel_common.check_kernel_support`:
activation, dtype, head, propagation) is checked where they are built, and by "auto".

``"auto"`` (resolved per solver, again at ``switch_solver``) is the counterpart of
``blackbox_mpc_tpu/ops/backend_select.py``, with its structure: the gates, then two measured
regimes, each set by constants that a re-measurement on other hardware changes without
touching the code. Off ``cuda`` it is ``"eager"`` (the kernels are CUDA).

* ``"kernel"`` for learned MLPs up to ``KERNEL_MAX_WIDTH`` wide and ``KERNEL_MAX_ROWS``
  candidate rows. These are the JAX package's ``PALLAS_MAX_WIDTH``/``PALLAS_MAX_ROWS``, which
  are 0 there: on its TPU the XLA path won every shape that fits in memory. On the H100 the
  CUDA kernel wins: ``act()`` at H=50 over populations 100-10 000 and hidden widths (64, 64)
  and (500, 500, 500), ``chip_smoke.py`` phase 9 Part A (PERF.md section 5 has the table and
  the card). ``ts_inf`` (which JAX sends to XLA) counts its rows as particle rows (population
  x particles x agents) against the same limit: at PETS' shape the kernel beat the graphed
  eager path through 10 000 particle rows (the measurement is beside ``KERNEL_MAX_ROWS``). Its
  layers may be no wider than ``KERNEL_TS_INF_MAX_WIDTH``, the widest measured. The kernel
  evaluator's member-major blocks (ts1, ts_inf) need rows that the ensemble divides.
* ``"fused"`` only for capacity, as in JAX: when the candidate tensor ``[P, A, H, U]`` reaches
  ``FUSED_MIN_BYTES``, which the other two paths materialize, within the in-kernel RNG's
  counter range and, for ts1, with a logical tile for every member. The fused family clips
  its normals at +/-2 sigma where the other two paths draw the truncated normal
  (``core/types.py::truncated_normal``), so it is not picked for speed. The capacity test
  comes first: the ``"kernel"`` path materializes the candidates as eager does, so a
  population beyond memory cannot run there either (JAX tests its kernel regime first, which
  it never enables). ``ts_inf`` never goes to ``"fused"``: past the threshold it stays on
  ``"kernel"`` or ``"eager"`` by the kernel regime.

Everything else is ``"eager"``. With a ``mesh`` of D devices the capacity threshold applies to
the whole candidate tensor, where JAX divides it by D: JAX shards the candidates, but every
rank of this port's sharded eager solve draws and holds all of them
(``parallel/sharding.py``) and rolls out only its block, so its peak is no smaller than the
single-device eager peak at the same population less the other blocks' rollout. Past the
threshold, the time-major layout, a population that D does not divide and the
injected-candidate features, which the sharded fused solvers refuse, stay eager with a
warning. A ``"fused"`` that "auto" picks for capacity and that the policy's smoothness cost,
discount or ``shard_axis="agents"`` refuses raises, as JAX's policy does.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from blackbox_mpc_torch.models.latent import LatentModelConfig
from blackbox_mpc_torch.ops._kernel_common import check_kernel_support
from blackbox_mpc_torch.parallel.mesh import POP_AXIS

__all__ = ["choose_backend", "FUSED_FAMILY", "FUSED_MIN_BYTES", "KERNEL_MAX_ROWS",
           "KERNEL_MAX_WIDTH", "KERNEL_TS_INF_MAX_WIDTH"]

# The "kernel" regime (JAX: PALLAS_MAX_WIDTH / PALLAS_MAX_ROWS, both 0 on its TPU). Set from
# chip_smoke.py phase 9 Part A (NVIDIA H100 80GB HBM3, 700 W): "kernel" beat "eager" at every
# measured shape, up to the 500-wide flagship and 10 000 rows, where the two nearly meet
# (448.5 against 459.5 ms an act(); PERF.md section 5).
# ts_inf counts particle rows against KERNEL_MAX_ROWS: at PETS' shape (4 x 200 swish, 5 members,
# 20 particles, H=30; ops/measure.py cases, the same H100) the kernel's evaluation, on its
# 3xTF32 tensor-core layers (TILE_TS_INF: 40 rows on 512 threads), beat the graphed eager one
# at every measured size: 1.61-1.65 against 2.89-2.90 ms at 1000 particle rows, 1.67-1.82
# against 4.74-4.75 at 5000 (one wave), 3.28-3.30 against 6.96-7.42 at 10 000 and 6.46-6.52
# against 12.5-12.7 at 20 000; the float32 SIMT loop before it took 2.04, 2.12-2.20, 4.10 and
# 7.93. Its layers were timed on PETS' 200-wide net only, so no wider ts_inf net goes to the
# kernel (KERNEL_TS_INF_MAX_WIDTH).
KERNEL_MAX_WIDTH = 500
KERNEL_MAX_ROWS = 10_000
KERNEL_TS_INF_MAX_WIDTH = 200

# The "fused" regime (JAX: FUSED_CEM_MIN_BYTES, 4 GiB for its 16 GB TPU). Set from
# chip_smoke.py phase 9 Part A (NVIDIA H100 80GB HBM3, 700 W) at the flagship (H=50, U=6,
# 5 x 3x500): the path that runs just below this threshold is "eager" (beyond
# KERNEL_MAX_ROWS), whose peak memory grows by 21.4 KB per candidate row between 20 000 and
# 60 000 rows (17.9 bytes per candidate byte; "kernel": 10.0 between 1000 and 3000 rows). At
# 2.38e9 candidate bytes the eager peak would reach half of the card's 85.0 GB; one eager
# act() at the largest population below this constant checks it on the card.
FUSED_MIN_BYTES = 2_350_000_000

# The fused solver family: registry name -> the factory of ops/fused_cem.py behind it, and of
# ops/fused_sharded.py with a mesh ("make_sharded_" in place of "make_").
_FUSED_FACTORIES = {
    "CEM": "make_fused_cem",
    "PI2": "make_fused_pi2",
    "MPPI": "make_fused_pi2",
    "RandomSearch": "make_fused_random_search",
    "CMA-ES": "make_fused_sep_cma",  # requires diagonal=True (the factory checks)
}
FUSED_FAMILY = tuple(_FUSED_FACTORIES)
# The solvers that differentiate through the rollout: eager only.
_FIRST_ORDER = ("Gradient", "CEM-GD")
# The fused CEM's logical ts1 tile (ops/fused_cem.py::make_fused_cem_kernels' default).
_FUSED_TILE = 256


class _Solve(NamedTuple):
    """What the rules read of a solve. ``config``: a ``LearnedDynamicsConfig``, a
    ``LatentModelConfig`` or None (a true model). ``requested``: the backend asked for."""
    config: object
    penalized: bool
    solver_name: str
    solver_config: object
    mesh: object = None
    shard_axis: str = "population"
    discount: float = 1.0
    smoothness: float = 0.0
    requested: str = "auto"


class _Rule(NamedTuple):
    """A refusal of a backend: whether it ``refuses`` a solve, and its ``message`` (of the
    solve and the backend)."""
    refuses: Callable[[_Solve], bool]
    message: Callable[[_Solve, str], str]


def _fused_only(what: str, cure: str) -> Callable[[_Solve, str], str]:
    """The message of a refusal that "auto" meets too, after picking "fused" for capacity."""
    def message(s: _Solve, backend: str) -> str:
        if s.requested != "auto":
            return f"{what}; {cure}"
        return ("rollout_backend='auto' selected the fused solver (a candidate tensor beyond the "
                f"capacity threshold), but {what}; pick a smaller population or {cure}")
    return message


def _sampled(propagations: tuple) -> _Rule:
    return _Rule(
        lambda s: getattr(s.config, "propagation", None) in propagations,
        lambda s, b: (f"rollout_backend={b!r} does not support propagation="
                      f"{s.config.propagation!r} (the fused kernels are deterministic, and the "
                      "rollout kernel samples ts_inf only); use the 'eager' backend"))


_TRUE_MODEL = _Rule(lambda s: s.config is None,
                    lambda s, b: f"rollout_backend={b!r} requires learned MLP dynamics")
_LATENT = _Rule(
    lambda s: isinstance(s.config, LatentModelConfig),
    lambda s, b: ("a latent world model plans on the single-device 'eager' backend (the kernels "
                  "roll out MLP ensembles, and the sharded evaluator has no terminal value); "
                  f"got rollout_backend={s.requested!r}" + ("" if s.mesh is None else " with a mesh")))
_PENALTY = _Rule(
    lambda s: s.penalized,
    lambda s, b: (f"rollout_backend={b!r} does not support plan_uncertainty_penalty (the "
                  "kernels roll out penalty-free dynamics); use the 'eager' backend"))
_TIME_MAJOR = _Rule(
    lambda s: bool(getattr(s.solver_config, "time_major", False)),
    lambda s, b: (f"time_major=True requires the eager evaluator; the {b!r} backend's "
                  "candidate contract is [P, A, H, U]"))

# Each backend's refusals, in the order they are checked.
_RULES: dict[str, tuple[_Rule, ...]] = {
    "eager": (_Rule(lambda s: s.mesh is not None and _LATENT.refuses(s), _LATENT.message),),
    "kernel": (
        _TRUE_MODEL, _LATENT, _PENALTY, _sampled(("mm",)),
        _Rule(lambda s: s.mesh is not None,
              lambda s, b: ("rollout_backend='kernel' and mesh= are mutually exclusive (the "
                            "rollout kernel is single-device); shard on 'eager' or 'fused'")),
        _Rule(lambda s: s.solver_name in _FIRST_ORDER,
              lambda s, b: (f"rollout_backend='kernel' cannot back the first-order "
                            f"{s.solver_name} solver (the rollout kernel has no VJP)")),
        _TIME_MAJOR,
    ),
    "fused": (
        _TRUE_MODEL, _LATENT, _PENALTY, _sampled(("ts_inf", "mm")),
        _Rule(lambda s: s.mesh is not None and s.shard_axis != "population",
              _fused_only("the sharded fused solvers shard the population axis, and "
                          "shard_axis='agents' shards the agents",
                          "use shard_axis='population' or the 'eager' backend")),
        _Rule(lambda s: s.smoothness > 0,
              _fused_only("action_smoothness_weight needs the candidate tensor, which the fused "
                          "solvers never hold", "use the 'eager' or 'kernel' backend")),
        _Rule(lambda s: s.discount != 1.0,
              _fused_only("the fused solver kernels sum undiscounted rewards (discount=1.0)",
                          "use the 'eager' or 'kernel' backend")),
        _Rule(lambda s: s.solver_name not in _FUSED_FACTORIES,
              lambda s, b: ("rollout_backend='fused' backs the generate-in-kernel solver "
                            f"family {FUSED_FAMILY} (CMA-ES with diagonal=True), not "
                            f"{s.solver_name}")),
        _TIME_MAJOR,  # last: "auto" warns where it is all that keeps a population off "fused"
    ),
}


def _refusal(backend: str, solve: _Solve) -> Optional[_Rule]:
    """The first rule of ``backend`` that refuses ``solve``, or None."""
    return next((rule for rule in _RULES[backend] if rule.refuses(solve)), None)


def _kernels_run(config, rollout: bool) -> bool:
    try:
        check_kernel_support(config, "auto", rollout=rollout)
    except ValueError:
        return False
    return True


def _platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_backend(requested: str, config, penalized: bool, solver_name: str, solver_config,
                    num_agents: int, horizon: int, dim_u: int, mesh=None,
                    shard_axis: str = "population", discount: float = 1.0,
                    smoothness: float = 0.0, platform: Optional[str] = None) -> str:
    """The backend that runs a solve: ``requested`` (``"eager"``, ``"kernel"``, ``"fused"``),
    or ``"auto"``'s choice (:func:`choose_backend`). Raises ``ValueError`` with the first rule
    of that backend that refuses the solve. ``config``: the handler's (None for a true model);
    ``penalized``: whether it plans with ``plan_uncertainty_penalty``; ``platform``: the
    policy's device type."""
    backend = requested
    if requested == "auto":
        backend = choose_backend(
            config, getattr(solver_config, "population", 0), num_agents, mesh=mesh,
            platform=platform, horizon=horizon, dim_u=dim_u, solver_name=solver_name,
            solver_config=solver_config)
    solve = _Solve(config, penalized, solver_name, solver_config, mesh, shard_axis, discount,
                   smoothness, requested)
    rule = _refusal(backend, solve)
    if rule is not None:
        raise ValueError(rule.message(solve, backend))
    return backend


def choose_backend(
    config,  # LearnedDynamicsConfig | LatentModelConfig | None (None: a true model)
    population: int,
    num_agents: int,
    mesh: Optional[object] = None,
    platform: Optional[str] = None,
    horizon: int = 0,
    dim_u: int = 0,
    solver_name: str = "",
    solver_config: Optional[object] = None,
) -> str:
    """``"eager"``, ``"kernel"`` or ``"fused"`` for a solve configuration; never raises for
    one the port runs.

    ``platform`` is the policy's device type (``"cuda"``, ``"cpu"``); None means ``cuda``
    where CUDA is available. ``mesh``: anything with ``shape["pop"]`` (a
    :class:`~blackbox_mpc_torch.parallel.mesh.PopMesh`).
    """
    if platform is None:
        platform = _platform()
    if platform != "cuda":
        return "eager"
    solve = _Solve(config, getattr(config, "plan_uncertainty_penalty", 0) > 0, solver_name,
                   solver_config, mesh)
    fused_refusal = _refusal("fused", solve)
    # time_major keeps a population past the capacity threshold eager with a warning (below).
    fused_ok = (fused_refusal in (None, _TIME_MAJOR)
                and _kernels_run(config, rollout=False)
                and (solver_name != "CMA-ES" or getattr(solver_config, "diagonal", False)))
    kernel_ok = _refusal("kernel", solve) is None and _kernels_run(config, rollout=True)
    if not (fused_ok or kernel_ok):
        return "eager"
    devices = 1 if mesh is None else int(mesh.shape[POP_AXIS])
    rows = population * num_agents
    local_rows = -(-rows // devices)  # each rank's block of a sharded fused solve
    ts1 = config.propagation == "ts1" and config.ensemble_size > 1
    ts_inf = config.propagation == "ts_inf"
    # K2's rows: ts_inf rolls each candidate out once per particle.
    kernel_rows = rows * (config.num_particles if ts_inf else 1)
    # The whole tensor: the eager path holds it on every rank of a mesh.
    candidate_bytes = rows * horizon * dim_u * 4
    rng_cols = (((horizon // 2 + 1) * 2) * dim_u
                if getattr(solver_config, "colored_noise_beta", 0.0) > 0.0
                else horizon * dim_u)
    if (
        fused_ok
        and candidate_bytes >= FUSED_MIN_BYTES
        and local_rows * rng_cols < 2**32  # the in-kernel RNG counter range
        # ts1 gives every member at least one logical tile
        and not (ts1 and -(-local_rows // _FUSED_TILE) < config.ensemble_size)
    ):
        # What keeps such a population on the eager path, which will likely run out of
        # memory: honour it, but warn, as JAX does for the time-major layout.
        if fused_refusal is _TIME_MAJOR:
            why, cure = ("time_major=True forces the eager evaluator",
                         "Drop time_major (the fused backend never materializes candidates)")
        elif population % devices:
            why, cure = (f"the sharded fused solvers need a population ({population}) that "
                         f"the mesh's {devices} devices divide",
                         f"Round the population to a multiple of {devices}")
        elif mesh is not None and any(getattr(solver_config, name, False) for name in
                                      ("keep_elites", "mean_as_candidate", "execute_best")):
            why, cure = ("the sharded fused solvers refuse keep_elites/mean_as_candidate/"
                         "execute_best", "Drop them")
        else:
            return "fused"
        warnings.warn(
            f"{why}, but the candidate tensor ({candidate_bytes / 2**30:.1f} GiB) is beyond "
            f"the fused backend's threshold; the eager solve will likely run out of memory. "
            f"{cure} or shrink the population.",
            RuntimeWarning, stacklevel=2,
        )
        return "eager"
    if (
        kernel_ok
        and KERNEL_MAX_WIDTH
        and max(config.hidden, default=0) <= (KERNEL_TS_INF_MAX_WIDTH if ts_inf
                                              else KERNEL_MAX_WIDTH)
        and kernel_rows <= KERNEL_MAX_ROWS
        # the kernel evaluator's member-major blocks (ts1, ts_inf) need rows % E == 0
        and not ((ts1 or ts_inf) and kernel_rows % config.ensemble_size)
    ):
        return "kernel"
    return "eager"
