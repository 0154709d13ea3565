from blackbox_mpc_torch.workflows.device_episode import evaluate_solver_on_model
from blackbox_mpc_torch.workflows.dynamics_learning import learn_dynamics_from_policy
from blackbox_mpc_torch.workflows.iterative_mpc import learn_dynamics_iteratively_w_mpc
from blackbox_mpc_torch.workflows.recording import record_rollout
from blackbox_mpc_torch.workflows.rollouts import RolloutResult, perform_rollouts

__all__ = [
    "evaluate_solver_on_model",
    "perform_rollouts",
    "RolloutResult",
    "learn_dynamics_from_policy",
    "learn_dynamics_iteratively_w_mpc",
    "record_rollout",
]
