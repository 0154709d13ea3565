from blackbox_mpc_torch.models.analytic import (
    ANALYTIC_MODELS,
    angle_normalize,
    cartpole_dynamics,
    cartpole_reward,
    pendulum_dynamics,
    pendulum_reward,
)
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.dynamics import (
    DynamicsParams,
    LearnedDynamicsConfig,
    make_learned_dynamics,
    true_model_dynamics,
    ts_member_ids,
)
from blackbox_mpc_torch.models.latent import LatentModelConfig, LatentWorldModel
from blackbox_mpc_torch.models.mlp import (
    MLPConfig,
    ensemble_apply,
    ensemble_init,
    mlp_apply,
    mlp_init,
)
from blackbox_mpc_torch.models.normalizer import NormalizerStats, fit_normalizer, identity_stats
from blackbox_mpc_torch.models.rssm import RSSMConfig, RSSMWorldModel
from blackbox_mpc_torch.models.vjepa2_ac import VJEPA2ACConfig, VJEPA2ACWorldModel

__all__ = [
    "ANALYTIC_MODELS", "DynamicsParams", "LatentModelConfig", "LatentWorldModel",
    "LearnedDynamicsConfig", "MLPConfig",
    "NormalizerStats", "RSSMConfig", "RSSMWorldModel", "VJEPA2ACConfig", "VJEPA2ACWorldModel",
    "angle_normalize", "cartpole_dynamics", "cartpole_reward",
    "dynamics_params_from_numpy", "ensemble_apply", "ensemble_init", "fit_normalizer",
    "identity_stats", "make_learned_dynamics", "mlp_apply", "mlp_init", "pendulum_dynamics",
    "pendulum_reward", "true_model_dynamics", "ts_member_ids",
]
