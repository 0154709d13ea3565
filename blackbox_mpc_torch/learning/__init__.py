from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.learning.proposer import PolicyProposer, ProposerConfig
from blackbox_mpc_torch.learning.replay import ReplayBuffer
from blackbox_mpc_torch.learning.trainer import TrainState, make_trainer

__all__ = ["DynamicsHandler", "PolicyProposer", "ProposerConfig", "ReplayBuffer", "TrainState",
           "make_trainer"]
