"""The three JAX training checkpoints committed under ``benchmarks/`` (HalfCheetah, S=18, U=6,
a 5-member 3x256 tanh Gaussian ensemble) carried into the port and held against JAX:

* ``ckpt_gradient_bc_300``: ``probabilistic``, ``mean``;
* ``ckpt_tsinf_p20``: ``ts_inf``, 20 particles (its ``config.json`` predates the
  ``learn_logvar_bounds`` key: the default applies);
* ``ckpt_tsinf_p20_lvb``: the same with learned logvar bounds (the dict layout).

Each is read once per module with JAX's ``DynamicsHandler.load`` (which writes nothing) and
carried over with ``handler_from_numpy``. Tolerances: the means on 256 replay rows 1e-5; the
``ts_inf`` returns with K=20 at population 16, H=15, two agents, fed JAX's draws, 1e-4 of
max(1, max|JAX|) (``ckpt_tsinf_p20``: see ``FREE_RUNNING_TOL``), and each of their steps from
JAX's own states 1e-5 of it; one train step's losses and parameters 1e-5;
``calibration_summary`` 1e-5.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackbox_mpc_tpu.learning.calibration import calibration_summary as j_calibration
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models import dynamics as jdyn
from blackbox_mpc_tpu.rollout import evaluator as jev
from blackbox_mpc_torch import DynamicsHandler
from blackbox_mpc_torch.learning.calibration import calibration_summary
from blackbox_mpc_torch.learning.handler import config_from_json
from blackbox_mpc_torch.learning.trainer import flat_params
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import handler_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.rollout import evaluator as tev

ROOT = Path(__file__).resolve().parents[1] / "benchmarks"
CHECKPOINTS = ("ckpt_gradient_bc_300", "ckpt_tsinf_p20", "ckpt_tsinf_p20_lvb")
LEARNING_RATE = 3e-3  # the committed runs' (benchmarks/cheetah_mbrl.py)
MEAN_TOL, RETURN_TOL, STEP_TOL, CAL_TOL = 1e-5, 1e-4, 1e-5, 1e-5
# A free-running rollout compounds float32 rounding at the rate the model expands it.
# ckpt_tsinf_p20's fixed-bound heads sample noise far larger than their residuals (the JAX
# package's calibration study), which carries its rollouts to states of |v| ~ 150 where the
# model is expansive: its steps agree to 4e-7 relative from the same state, and the gap about
# doubles at every step (measured: 3e-4 of max|return| at H=15; the other two, 1e-6).
FREE_RUNNING_TOL = {"ckpt_tsinf_p20": 2e-3}
POP, AGENTS, HORIZON, PARTICLES = 16, 2, 15, 20


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=CHECKPOINTS)
def loaded(request):
    """``(name, JAX handler, numpy checkpoint)``: the JAX handler as its ``load`` restores it,
    and the arguments of ``handler_from_numpy``."""
    directory = ROOT / request.param / "handler"
    jh = JHandler.load(str(directory), learning_rate=LEARNING_RATE)
    ts = jh._train_state
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    checkpoint = dict(
        meta=json.loads((directory / "config.json").read_text()), params=to_np(ts.params),
        opt_state=to_np(ts.opt_state), step=np.asarray(ts.step),
        stats={f: np.asarray(getattr(jh.dynamics_params.stats, f)) for f in STATS_FIELDS},
        replay=jh.replay.state_dict())
    return request.param, jh, checkpoint


def port(checkpoint) -> DynamicsHandler:
    return handler_from_numpy(**checkpoint, device="cpu", learning_rate=LEARNING_RATE)


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def close_to_scale(got, want, tol):
    """``max|got - want| <= tol * max(1, max|want|)``."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def cheetah_reward(xp):
    def reward(s, a, ns):  # benchmarks/cheetah_mbrl.py:90-93
        return (ns[:, 0] - s[:, 0]) / 0.05 - 0.1 * xp.sum(xp.square(a), -1)
    return reward


def test_config_and_layout_carried_over(loaded):
    _, jh, checkpoint = loaded
    th = port(checkpoint)
    assert th.config == config_from_json(checkpoint["meta"]["config"])
    assert dataclasses.asdict(th.config) == {**dataclasses.asdict(jh.config),
                                             "compute_dtype": torch.float32}
    learned = th.config.learn_logvar_bounds
    assert isinstance(th.dynamics_params.params, dict) == learned
    assert len(th.train_state.optimizer.state_dict()["state"]) == 8 + 2 * learned
    assert th.train_state.step == int(checkpoint["step"])
    for k, v in checkpoint["replay"].items():
        np.testing.assert_array_equal(th.replay.state_dict()[k], v)


def test_means_match_jax(loaded):
    _, jh, checkpoint = loaded
    th = port(checkpoint)
    s, a, _ = jh.replay.arrays()
    s, a = s[:256], a[:256]
    want = jh.mean_dynamics_fn(jh.dynamics_params, jnp.asarray(s), jnp.asarray(a))
    close(th.mean_dynamics_fn(th.dynamics_params, torch.as_tensor(s), torch.as_tensor(a)),
          want, MEAN_TOL)


def test_ts_inf_returns_match_jax(loaded, rng):
    """``ts_inf`` with 20 particles on the checkpoint's weights (``ckpt_gradient_bc_300``
    trained for ``mean`` propagation: the same weights sampled the PETS way)."""
    name, jh, checkpoint = loaded
    th = port(checkpoint)
    changes = dict(propagation="ts_inf", num_particles=PARTICLES)
    _, jfn = jdyn.make_learned_dynamics(dataclasses.replace(jh.config, **changes))
    _, tfn = tdyn.make_learned_dynamics(dataclasses.replace(th.config, **changes))
    jdp, tdp = jh.dynamics_params, th.dynamics_params
    j_eval = jev.make_trajectory_evaluator(lambda s, a, k=None: jfn(jdp, s, a, k),
                                           cheetah_reward(jnp), num_particles=PARTICLES)
    t_eval = tev.make_trajectory_evaluator(lambda s, a, n=None: tfn(tdp, s, a, n),
                                           cheetah_reward(torch), num_particles=PARTICLES,
                                           device="cpu")
    s0 = jh.replay.arrays()[0][-AGENTS:]
    acts = rng.uniform(-1, 1, (POP, AGENTS, HORIZON, 6)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = j_eval(jnp.asarray(s0), jnp.asarray(acts), key)
    rows = POP * PARTICLES * AGENTS
    noise = np.stack([np.asarray(jax.random.normal(k, (rows, 18), jnp.float32))
                      for k in jax.random.split(key, HORIZON)])
    got = t_eval(torch.as_tensor(s0), torch.as_tensor(acts), torch.as_tensor(noise))
    close_to_scale(got, want, FREE_RUNNING_TOL.get(name, RETURN_TOL))
    # Each step from JAX's own visited states: the evaluator's row layout (particle j of
    # candidate i on rows (i*K + j)*A + a), the member of each row and the draw it reads.
    flat_s0 = np.tile(s0, (POP * PARTICLES, 1))
    flat_a = np.repeat(acts, PARTICLES, axis=0).reshape(rows, HORIZON, 6)
    _, states = jev.rollout_trajectories(lambda s, a, k: jfn(jdp, s, a, k), cheetah_reward(jnp),
                                         jnp.asarray(flat_s0), jnp.asarray(flat_a), key=key,
                                         return_states=True)
    states = np.asarray(states)
    prev = np.concatenate([flat_s0[None], states[:-1]])
    for step in range(HORIZON):
        close_to_scale(tfn(tdp, torch.as_tensor(prev[step]), torch.as_tensor(flat_a[:, step]),
                           torch.as_tensor(noise[step])), states[step], STEP_TOL)


def test_train_step_matches_jax(loaded):
    """One Adam step from the checkpoint's optimizer state: the member losses and every
    parameter, the bounds and their moments (by key) included."""
    _, jh, checkpoint = loaded
    th = port(checkpoint)
    s, a, ns = next(jh.replay.minibatches(256, jh.config.ensemble_size))
    jstate = jax.tree_util.tree_map(jnp.asarray, jh._train_state)
    jts, jl = jh._train_step(jstate, jh.dynamics_params.stats, s, a, ns)
    ts, tl = th._train_step(th.train_state, th.dynamics_params.stats,
                            *(torch.as_tensor(x) for x in (s, a, ns)))
    close(tl, jl, STEP_TOL)
    jflat = jax.tree_util.tree_map(np.asarray, jts.params)
    jlist = [layer[k] for layer in (jflat["net"] if isinstance(jflat, dict) else jflat)
             for k in ("w", "b")]
    if isinstance(jflat, dict):
        jlist += [jflat["lv_min"], jflat["lv_max"]]
    for got, want in zip(flat_params(ts.params), jlist, strict=True):
        close(got, want, STEP_TOL)


def test_calibration_matches_jax(loaded):
    _, jh, checkpoint = loaded
    want, got = j_calibration(jh), calibration_summary(port(checkpoint))
    assert got["val_points"] == want["val_points"] == jh.replay.num_val
    for k in ("variance_ratio", "per_dim_variance_ratio"):
        close(got[k], want[k], CAL_TOL)
    cells = 18 * jh.config.ensemble_size * want["val_points"]
    for k in ("coverage_1sigma", "coverage_2sigma"):  # a |z| at the edge may fall either way
        assert abs(got[k] - want[k]) <= 10.0 / cells


def test_port_save_load_bit_for_bit(loaded, tmp_path):
    th = port(loaded[2])
    th.save(str(tmp_path / "ckpt"))
    back = DynamicsHandler.load(str(tmp_path / "ckpt"), device="cpu",
                                learning_rate=LEARNING_RATE)
    for a, b in zip(flat_params(th.train_state.params), flat_params(back.train_state.params),
                    strict=True):
        assert torch.equal(a, b)
    for a, b in zip(flat_params(th.dynamics_params.params),
                    flat_params(back.dynamics_params.params), strict=True):
        assert torch.equal(a, b)
    sa, sb = (h.train_state.optimizer.state_dict()["state"] for h in (th, back))
    assert sa.keys() == sb.keys() and back.train_state.step == th.train_state.step
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k])
    for f in STATS_FIELDS:
        assert torch.equal(getattr(th.dynamics_params.stats, f),
                           getattr(back.dynamics_params.stats, f))
    for k, v in th.replay.state_dict().items():
        np.testing.assert_array_equal(back.replay.state_dict()[k], v)
