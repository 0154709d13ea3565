from blackbox_mpc_torch.policies.base import ModelBasedPolicy, ModelFreePolicy, Policy
from blackbox_mpc_torch.policies.mpc_policy import MPCPolicy
from blackbox_mpc_torch.policies.random_policy import RandomPolicy

__all__ = ["MPCPolicy", "ModelBasedPolicy", "ModelFreePolicy", "Policy", "RandomPolicy"]
