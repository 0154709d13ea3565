"""blackbox_mpc_torch: the PyTorch/CUDA port of blackbox_mpc_tpu for NVIDIA Hopper GPUs.

A second package beside ``blackbox_mpc_tpu`` (the JAX reference it is tested against). It
imports torch and numpy only, never JAX nor the JAX package. It runs CEM-MPC ``act()`` (and
the fused solver family) over a learned MLP ensemble, with the rollout as a hand-written CUDA
kernel (``rollout_backend="kernel"``) or an eager PyTorch loop (``"eager"``), and the
generate-in-kernel solvers, whose CUDA kernels draw, roll out and reduce the candidates without
storing them (``"fused"``); and the loop around it: vectorized envs, rollouts, the replay, the
trainer, checkpoints and the MBRL workflows. Probabilistic (PETS) ensembles plan on
``"eager"``: Gaussian heads with fixed or learned logvar bounds, ``ts_inf``/``mm`` propagation
with particles, the uncertainty penalty, and the heads' calibration after each training;
``ts_inf`` plans on ``"kernel"`` too. All
nine solvers of the JAX registry run, the sampled ones in both candidate layouts; the
first-order Gradient and CEM-GD differentiate through the eager rollout. A behaviour-cloned
policy proposer seeds the solver's plan, and a speculative pipeline overlaps the next solve
with the env step (``perform_rollouts(overlap=True)``). ``rollout_backend="auto"`` picks the
backend by a rule measured on the H100; a policy exports to a ``.bbmpc`` artifact
(``torch.export``) that :class:`ServingPolicy` serves without the package, compiled ahead of
time with AOTInductor when asked (``precompile``, ``save_compiled``, ``compiled_cache=``); and
``python -m blackbox_mpc_torch`` runs the JAX package's command line. The low-level API
(``make_trajectory_evaluator``, ``make_solver`` and the solver's ``init``/``solve`` with a
``torch.Generator``) is exported here as in the JAX package.
"""
from blackbox_mpc_torch.core import Bounds, BoxSpace, Solver, SolverAux, as_box_space
from blackbox_mpc_torch.deploy import ServingPolicy, export_dynamics, export_policy_artifact
from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.policies.mpc_policy import MPCPolicy
from blackbox_mpc_torch.policies.random_policy import RandomPolicy
from blackbox_mpc_torch.rollout import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY, make_solver
from blackbox_mpc_torch.utils.metrics import MetricsWriter
from blackbox_mpc_torch.workflows.dynamics_learning import learn_dynamics_from_policy
from blackbox_mpc_torch.workflows.iterative_mpc import learn_dynamics_iteratively_w_mpc
from blackbox_mpc_torch.workflows.recording import record_rollout
from blackbox_mpc_torch.workflows.rollouts import perform_rollouts

__version__ = "0.1.0"

__all__ = [
    "Bounds",
    "BoxSpace",
    "as_box_space",
    "Solver",
    "SolverAux",
    "SOLVER_REGISTRY",
    "make_solver",
    "make_trajectory_evaluator",
    "DynamicsHandler",
    "DynamicsParams",
    "LearnedDynamicsConfig",
    "MPCPolicy",
    "MetricsWriter",
    "RandomPolicy",
    "ServingPolicy",
    "export_dynamics",
    "export_policy_artifact",
    "learn_dynamics_from_policy",
    "learn_dynamics_iteratively_w_mpc",
    "perform_rollouts",
    "record_rollout",
    "__version__",
]
