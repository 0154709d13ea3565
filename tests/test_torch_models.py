"""Port parity: the MLP and the learned dynamics step of blackbox_mpc_torch against the JAX
package, on the same weights carried over by the bridge (f32 at rtol 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackbox_mpc_tpu.models import dynamics as jdyn
from blackbox_mpc_tpu.models import mlp as jmlp
from blackbox_mpc_tpu.models.normalizer import NormalizerStats as JStats
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models import mlp as tmlp
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS

S, U = 3, 2


def jax_params_numpy(dp):
    params = jax.tree_util.tree_map(np.asarray, dp.params)
    stats = {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}
    return params, stats


def nontrivial_stats(rng):
    return JStats(
        mean_states=jnp.asarray(rng.normal(0, 0.3, S), jnp.float32),
        std_states=jnp.asarray(rng.uniform(0.5, 2.0, S), jnp.float32),
        mean_actions=jnp.asarray(rng.normal(0, 0.3, U), jnp.float32),
        std_actions=jnp.asarray(rng.uniform(0.5, 2.0, U), jnp.float32),
        mean_targets=jnp.asarray(rng.normal(0, 0.1, S), jnp.float32),
        std_targets=jnp.asarray(rng.uniform(0.2, 1.0, S), jnp.float32),
    )


def torch_config(cfg, **changes):
    fields = dict(
        dim_s=cfg.dim_s, dim_u=cfg.dim_u, hidden=tuple(cfg.hidden), activation=cfg.activation,
        ensemble_size=cfg.ensemble_size, propagation=cfg.propagation,
        normalized=cfg.normalized, predict_delta=cfg.predict_delta,
    )
    fields.update(changes)
    return tdyn.LearnedDynamicsConfig(**fields)


@pytest.mark.parametrize("activation", ["tanh", "relu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(activation, dtype, rng):
    jcfg = jmlp.MLPConfig(in_dim=5, out_dim=3, hidden=(16, 16), activation=activation,
                          compute_dtype=getattr(jnp, dtype))
    params = jmlp.mlp_init(jax.random.PRNGKey(0), jcfg)
    x = rng.normal(0, 1, (7, 5)).astype(np.float32)
    ref = np.asarray(jmlp.mlp_apply(params, jnp.asarray(x), config=jcfg))
    tcfg = tmlp.MLPConfig(in_dim=5, out_dim=3, hidden=(16, 16), activation=activation,
                          compute_dtype=getattr(torch, dtype))
    tparams = [{k: torch.as_tensor(np.asarray(v))[None] for k, v in layer.items()}
               for layer in params]
    out = tmlp.mlp_apply(tparams, torch.as_tensor(x), config=tcfg).numpy()
    assert out.dtype == np.float32
    # bf16: a 1-ulp difference in a rounded activation (2^-8) may propagate; f32 is tight.
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "ensemble,propagation,batch,normalized",
    [(1, "mean", 8, True), (3, "mean", 8, True), (3, "mean", 8, False),
     (3, "ts1", 9, True), (3, "ts1", 10, True)],  # batch 10: edge-padded ts1
)
def test_dynamics_step_matches_jax(ensemble, propagation, batch, normalized, rng):
    jcfg = jdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=ensemble,
                                      propagation=propagation, normalized=normalized)
    init, jfn = jdyn.make_learned_dynamics(jcfg)
    dp = init(jax.random.PRNGKey(1)).replace(stats=nontrivial_stats(rng))
    s = rng.normal(0, 1, (batch, S)).astype(np.float32)
    a = rng.uniform(-1, 1, (batch, U)).astype(np.float32)
    ref = np.asarray(jfn(dp, jnp.asarray(s), jnp.asarray(a)))

    tcfg = torch_config(jcfg)
    _, tfn = tdyn.make_learned_dynamics(tcfg)
    tdp = dynamics_params_from_numpy(*jax_params_numpy(dp), tcfg, device="cpu")
    out = tfn(tdp, torch.as_tensor(s), torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_ts_member_ids_match_jax():
    for n, e in [(12, 3), (1000, 5), (64, 2)]:
        np.testing.assert_array_equal(tdyn.ts_member_ids(n, e), jdyn.ts_member_ids(n, e))


def test_bridge_rejects_wrong_shapes():
    jcfg = jdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=2)
    dp = jdyn.make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(0))
    params, stats = jax_params_numpy(dp)
    with pytest.raises(ValueError, match="layer"):
        dynamics_params_from_numpy(params, stats, torch_config(jcfg, hidden=(8,)), device="cpu")


def test_unported_dynamics_raise():
    """The probabilistic stack is ported: what raised NotImplementedError builds, and only
    the JAX package's ValueErrors are left (tests/test_torch_probabilistic.py holds them)."""
    for changes in (dict(propagation="ts_inf", probabilistic=True),
                    dict(propagation="mm", probabilistic=True),
                    dict(probabilistic=True),
                    dict(plan_uncertainty_penalty=0.5, ensemble_size=2)):
        cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, **changes)
        init, fn = tdyn.make_learned_dynamics(cfg)
        dp = init(torch.Generator().manual_seed(0))
        assert fn(dp, torch.zeros(4, S), torch.zeros(4, U)).shape == (4, S)
    with pytest.raises(ValueError, match="unknown propagation"):
        tdyn.make_learned_dynamics(tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, propagation="x"))


def test_glorot_init_bounds_and_zero_bias():
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(64,), ensemble_size=2)
    dp = tdyn.make_learned_dynamics(cfg)[0](torch.Generator().manual_seed(0))
    w0 = dp.params[0]["w"]
    assert w0.shape == (2, S + U, 64)
    limit = np.sqrt(6.0 / (S + U + 64))
    assert float(w0.abs().max()) <= limit and float(w0.abs().max()) > 0.9 * limit
    assert all(float(layer["b"].abs().max()) == 0.0 for layer in dp.params)
