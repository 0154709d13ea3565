"""Deployment and serving: export MPC policies as standalone ``torch.export`` artifacts.

Counterpart of ``blackbox_mpc_tpu/deploy``:

- :func:`export_policy_artifact` writes an ``MPCPolicy``'s whole solve step (solver iterations,
  rollouts, exploration noise, lookahead) into one ``.bbmpc`` file, with the solver state and
  the generator states;
- :class:`ServingPolicy` loads and serves it with no code of the package
  (``deploy/serving.py`` is self-contained);
- :func:`export_dynamics` exports the learned model alone, with a polymorphic batch.
"""
from blackbox_mpc_torch.deploy.export import export_dynamics, export_policy_artifact
from blackbox_mpc_torch.deploy.serving import ServingPolicy
from blackbox_mpc_torch.policies.base import ModelBasedPolicy as _ModelBasedPolicy

# A virtual subclass, not inheritance: serving.py imports nothing of the package, but a loaded
# ServingPolicy keeps the ModelBasedPolicy contract (act -> (action, predicted_next_obs,
# predicted_reward), reset), so the rollout runner treats it as model-based.
_ModelBasedPolicy.register(ServingPolicy)

__all__ = ["export_policy_artifact", "export_dynamics", "ServingPolicy"]
