from blackbox_mpc_torch.policies.base import ModelBasedPolicy, ModelFreePolicy, Policy
from blackbox_mpc_torch.policies.mpc_policy import MPCPolicy

__all__ = ["MPCPolicy", "ModelBasedPolicy", "ModelFreePolicy", "Policy"]
