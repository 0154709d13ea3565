from blackbox_mpc_torch.rollout.evaluator import (
    NAN_REWARD,
    action_smoothness_penalty,
    make_trajectory_evaluator,
    rollout_trajectories,
)

__all__ = [
    "NAN_REWARD", "action_smoothness_penalty", "make_trajectory_evaluator",
    "rollout_trajectories",
]
