"""blackbox_mpc_torch: the PyTorch/CUDA port of blackbox_mpc_tpu for NVIDIA Hopper GPUs.

A second package beside ``blackbox_mpc_tpu`` (the JAX reference it is tested against). It
imports torch and numpy only, never JAX nor the JAX package. So far it ports the main path:
CEM-MPC ``act()`` over a learned MLP ensemble, with the rollout as a hand-written CUDA kernel
(``rollout_backend="kernel"``) or an eager PyTorch loop (``"eager"``), and the
generate-in-kernel CEM, whose CUDA kernels draw, roll out and reduce the candidates without
storing them (``"fused"``).
"""
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
from blackbox_mpc_torch.policies.mpc_policy import MPCPolicy

__all__ = ["Bounds", "DynamicsHandler", "LearnedDynamicsConfig", "MPCPolicy"]
