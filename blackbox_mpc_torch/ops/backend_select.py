"""The measured rule behind ``MPCPolicy(rollout_backend="auto")``.

Counterpart of ``blackbox_mpc_tpu/ops/backend_select.py``, with its structure: the gates of
:func:`~blackbox_mpc_torch.ops._kernel_common.check_kernel_support` and of the policy, then
two measured regimes, each set by constants that a re-measurement on other hardware changes
without touching the code.

* ``"kernel"`` (K2 on the eager sampler: the same sampling law as ``"eager"``) for learned
  MLPs up to ``KERNEL_MAX_WIDTH`` wide and ``KERNEL_MAX_ROWS`` candidate rows. These are the
  JAX package's ``PALLAS_MAX_WIDTH``/``PALLAS_MAX_ROWS``, which are 0 there: on its TPU the
  XLA path won every shape that fits in memory. On the H100 the CUDA kernel wins: ``act()``
  at H=50 over populations 100-10 000 and hidden widths (64, 64) and (500, 500, 500),
  ``chip_smoke.py`` phase 9 Part A (PERF.md section 5 has the table and the card). PETS'
  TS-infinity (a probabilistic head with ``propagation="ts_inf"``, which JAX sends to XLA)
  takes the kernel too, its rows counted as particle rows (population x particles x agents)
  against the same limit: at PETS' shape the kernel beat the graphed eager path through
  10 000 particle rows (the measurement is beside ``KERNEL_MAX_ROWS``). Its layers may be no
  wider than ``KERNEL_TS_INF_MAX_WIDTH``, the widest measured.
* ``"fused"`` (the generate-in-kernel family: CEM, PI2, MPPI, RandomSearch, CMA-ES with
  ``diagonal=True``) only for capacity, as in JAX: when the candidate tensor ``[P, A, H, U]``
  reaches ``FUSED_MIN_BYTES``, which the other two paths materialize. The fused family clips
  its normals at +/-2 sigma where the other two paths draw the truncated normal
  (``core/types.py::truncated_normal``), so it is not picked for speed. The capacity test
  comes first here: the ``"kernel"`` path materializes the candidates as eager does, so a
  population beyond memory cannot run there either (JAX tests its kernel regime first, which
  it never enables).

Everything else is ``"eager"``: a device other than ``cuda`` (the kernels are CUDA, so a CPU
policy asked for ``auto`` is an eager policy), true models, latent world models
(``models/latent.py``: K2 and K4 compute only the MLP ensemble, and TD-MPC2's layers are past
``KERNEL_MAX_WIDTH``), probabilistic heads but ts_inf's, ``mm`` and propagation other than
mean/ts1/ts_inf with an ensemble, pessimistic planning (``plan_uncertainty_penalty``), an
activation or dtype the kernels refuse (swish runs in ts_inf's kernel only), the first-order
solvers (the kernels have no backward) and the time-major layout. ts_inf never goes to
``"fused"``, whose kernels are deterministic: past its capacity threshold it stays on
"kernel" or "eager" by the kernel regime.

With a ``mesh`` of D devices: never ``"kernel"`` (K2 is single-device, as JAX's ``pallas``).
The capacity threshold applies to the whole candidate tensor, where JAX divides it by D: JAX
shards the candidates, but every rank of this port's sharded eager solve draws and holds all
of them (``parallel/sharding.py``) and rolls out only its block, so its peak is no smaller
than the single-device eager peak at the same population less the other blocks' rollout.
Past the threshold, a population that D does not divide and the injected-candidate features,
which the sharded fused solvers refuse, stay eager with a warning, as ``time_major`` does.
"""
from __future__ import annotations

import warnings
from typing import Optional

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
# 20 particles, H=30; ops/measure.py cases, the same H100) the kernel's evaluation beat the
# graphed eager one at every measured size, 2.16 against 2.86 ms at 1000 particle rows, 2.25
# against 4.71 at 5000, 4.29 against 7.36 at 10 000 and 8.40 against 12.58 at 20 000. That
# tile (TILE_TS_INF: 40 rows on 512 threads, K split over lane pairs) was timed on PETS'
# 200-wide layers only, so no wider ts_inf net goes to the kernel (KERNEL_TS_INF_MAX_WIDTH).
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

# The fused solver family by registry name (CMA-ES with diagonal=True only).
FUSED_FAMILY = ("CEM", "PI2", "MPPI", "RandomSearch", "CMA-ES")
# The solvers that differentiate through the rollout: eager only.
_FIRST_ORDER = ("Gradient", "CEM-GD")
# The fused CEM's logical ts1 tile (ops/fused_cem.py::make_fused_cem_kernels' default).
_FUSED_TILE = 256


def _platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


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
    if platform != "cuda" or config is None or isinstance(config, LatentModelConfig):
        return "eager"
    try:
        check_kernel_support(config, "auto", rollout=True)
    except ValueError:
        return "eager"
    if solver_name in _FIRST_ORDER or config.plan_uncertainty_penalty > 0:
        return "eager"
    time_major = bool(getattr(solver_config, "time_major", False))
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
    fused_family = solver_name in FUSED_FAMILY and (
        solver_name != "CMA-ES" or getattr(solver_config, "diagonal", False))
    if (
        not ts_inf  # the fused kernels are deterministic
        and fused_family
        and candidate_bytes >= FUSED_MIN_BYTES
        and local_rows * rng_cols < 2**32  # the in-kernel RNG counter range
        # ts1 gives every member at least one logical tile
        and not (ts1 and -(-local_rows // _FUSED_TILE) < config.ensemble_size)
    ):
        # What keeps such a population on the eager path, which will likely run out of
        # memory: honour it, but warn, as JAX does for the time-major layout.
        if time_major:
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
        mesh is None  # K2 is single-device
        and not time_major  # the kernel's candidate contract is [P, A, H, U]
        and KERNEL_MAX_WIDTH
        and max(config.hidden, default=0) <= (KERNEL_TS_INF_MAX_WIDTH if ts_inf
                                              else KERNEL_MAX_WIDTH)
        and kernel_rows <= KERNEL_MAX_ROWS
        # the kernel evaluator's member-major blocks (ts1, ts_inf) need rows % E == 0
        and not ((ts1 or ts_inf) and kernel_rows % config.ensemble_size)
    ):
        return "kernel"
    return "eager"
