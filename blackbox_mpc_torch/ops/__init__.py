"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled on its first launch.
"""
from blackbox_mpc_torch.ops.rollout_kernel import make_rollout_kernel_evaluator, rollout_states

__all__ = ["make_rollout_kernel_evaluator", "rollout_states"]
