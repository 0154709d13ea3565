from blackbox_mpc_torch.learning.handler import DynamicsHandler

__all__ = ["DynamicsHandler"]
