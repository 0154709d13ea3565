from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.dynamics import (
    DynamicsParams,
    LearnedDynamicsConfig,
    make_learned_dynamics,
    ts_member_ids,
)
from blackbox_mpc_torch.models.mlp import MLPConfig, ensemble_apply, ensemble_init, mlp_apply
from blackbox_mpc_torch.models.normalizer import NormalizerStats, identity_stats

__all__ = [
    "DynamicsParams", "LearnedDynamicsConfig", "MLPConfig", "NormalizerStats",
    "dynamics_params_from_numpy", "ensemble_apply", "ensemble_init", "identity_stats",
    "make_learned_dynamics", "mlp_apply", "ts_member_ids",
]
