"""Port parity for the learning stack: analytic models, the normalizer fit, the replay buffer,
the trainer and ``DynamicsHandler.train``/``save``/``load`` of blackbox_mpc_torch against the
JAX package, on the same numpy inputs and the same starting weights (converted with
``dynamics_params_from_numpy``), plus the JAX -> port checkpoint cross-over."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.models as jmodels
import blackbox_mpc_tpu.models.analytic as janalytic
import blackbox_mpc_torch.models as tmodels
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.learning.replay import ReplayBuffer as JReplay
from blackbox_mpc_tpu.learning.trainer import make_trainer as j_make_trainer
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_torch.learning import DynamicsHandler, ReplayBuffer, make_trainer
from blackbox_mpc_torch.learning.trainer import flat_params
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy, handler_from_numpy
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.parallel import make_pop_mesh

# Tolerances of the trainer's float32 path: per-step losses rtol 1e-4, parameters after 20
# Adam steps 1e-4 absolute (the two sides reduce in other orders; Adam divides by sqrt(nu)).
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
BF16_LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(ensemble, dtype="float32", hidden=(32, 32)):
    return (JConfig(dim_s=3, dim_u=1, hidden=hidden, ensemble_size=ensemble,
                    compute_dtype=getattr(jnp, dtype)),
            LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=hidden, ensemble_size=ensemble,
                                  compute_dtype=getattr(torch, dtype)))


def transitions(n, seed=0):
    """Pendulum transitions from the JAX analytic model."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    s = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], -1).astype(np.float32)
    a = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    ns = np.asarray(jmodels.pendulum_dynamics(jnp.asarray(s), jnp.asarray(a)))
    return s, a, ns


def np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def np_stats(stats):
    return {f: np.asarray(getattr(stats, f)) for f in STATS_FIELDS}


def assert_params_close(tparams, jparams, atol):
    for t, j in zip(tparams, jparams):
        for k in ("w", "b"):
            want = np.asarray(j[k])
            got = t[k].detach().numpy()
            np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=atol)


def bridged(ensemble, seed=3, **handler_kwargs):
    """A JAX handler and a port handler that start from the JAX handler's weights."""
    jcfg, tcfg = configs(ensemble)
    jh = JHandler(config=jcfg, seed=seed, **handler_kwargs)
    th = DynamicsHandler(tcfg, seed=seed, device="cpu", **handler_kwargs)
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(np_params(dp.params), np_stats(dp.stats), tcfg,
                                             device="cpu"))
    return jh, th


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_analytic_models_match_jax(name, rng):
    jdyn, jrew = janalytic.ANALYTIC_MODELS[name]
    tdyn, trew = tmodels.ANALYTIC_MODELS[name]
    dim_s = 3 if name == "pendulum" else 4
    s = rng.normal(0, 2, (64, dim_s)).astype(np.float32)
    if name == "pendulum":
        th = rng.uniform(-4, 4, 64)
        s[:, 0], s[:, 1] = np.cos(th), np.sin(th)
        s[:5, 2] = [9.0, -9.0, 7.99, -7.99, 0.0]  # the velocity clip
    a = rng.uniform(-3, 3, (64, 1)).astype(np.float32)
    jns = np.asarray(jdyn(jnp.asarray(s), jnp.asarray(a)))
    tns = tdyn(torch.as_tensor(s), torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(tns, jns, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        trew(torch.as_tensor(s), torch.as_tensor(a), torch.as_tensor(tns)).numpy(),
        np.asarray(jrew(jnp.asarray(s), jnp.asarray(a), jnp.asarray(jns))), rtol=0, atol=1e-5)
    x = rng.uniform(-20, 20, 100).astype(np.float32)
    np.testing.assert_allclose(tmodels.angle_normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(janalytic.angle_normalize(jnp.asarray(x))), atol=1e-5)


def test_fit_normalizer_matches_jax(rng):
    s = rng.normal(3.0, 2.0, (300, 3)).astype(np.float32)
    a = rng.normal(-1.0, 0.5, (300, 1)).astype(np.float32)
    t = rng.normal(0.0, 4.0, (300, 3)).astype(np.float32)
    jst = jmodels.fit_normalizer(jnp.asarray(s), jnp.asarray(a), jnp.asarray(t))
    tst = tmodels.fit_normalizer(*(torch.as_tensor(x) for x in (s, a, t)))
    for f in STATS_FIELDS:  # the population std (ddof 0), as jnp.std
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                   rtol=1e-6)


# ------------------------------------------------------------------ replay


def test_replay_bit_for_bit_with_jax():
    jr, tr = JReplay(3, 1, validation_fraction=0.25, max_size=350, seed=4), \
        ReplayBuffer(3, 1, validation_fraction=0.25, max_size=350, seed=4)
    for seed in (0, 1):
        s, a, ns = transitions(200, seed)
        jr.add_transitions(s, a, ns)
        tr.add_transitions(s, a, ns)
    obs = [np.random.default_rng(2).normal(size=(11, 3))]
    acts = [np.random.default_rng(3).normal(size=(10, 1))]
    jr.add_rollouts(obs, acts)
    tr.add_rollouts(obs, acts)
    assert len(tr) == len(jr) == 350 and tr.num_val == jr.num_val
    for validation in (False, True):
        for j, t in zip(jr.arrays(validation), tr.arrays(validation)):
            np.testing.assert_array_equal(t, j)
    for kwargs in (dict(ensemble_size=5), dict(ensemble_size=1), dict(ensemble_size=3,
                   bootstrap=False), dict(ensemble_size=5, validation=True)):
        jb, tb = list(jr.minibatches(48, **kwargs)), list(tr.minibatches(48, **kwargs))
        assert len(tb) == len(jb)
        for j, t in zip(jb, tb):
            for x, y in zip(j, t):
                np.testing.assert_array_equal(y, x)
    # A JAX replay's state_dict loads unchanged and continues the same stream.
    resumed = ReplayBuffer(3, 1, validation_fraction=0.25, max_size=350, seed=99)
    resumed.load_state_dict(jr.state_dict())
    for k, v in jr.state_dict().items():
        np.testing.assert_array_equal(resumed.state_dict()[k], v)
    s, a, ns = transitions(50, 7)
    jr.add_transitions(s, a, ns)
    resumed.add_transitions(s, a, ns)
    np.testing.assert_array_equal(resumed.state_dict()["is_val"], jr.state_dict()["is_val"])
    for j, t in zip(jr.minibatches(64, 5), resumed.minibatches(64, 5)):
        np.testing.assert_array_equal(t[0], j[0])


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("ensemble,dtype", [(1, "float32"), (5, "float32"), (5, "bfloat16")])
def test_trainer_matches_jax(ensemble, dtype):
    jcfg, tcfg = configs(ensemble, dtype)
    jdp = jmodels.make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(1))
    s, a, ns = transitions(400)
    jstats = jmodels.fit_normalizer(jnp.asarray(s), jnp.asarray(a), jnp.asarray(ns - s))
    tdp = dynamics_params_from_numpy(np_params(jdp.params), np_stats(jstats), tcfg, device="cpu")
    j_init, j_step, j_eval = j_make_trainer(jcfg, learning_rate=3e-3)
    t_init, t_step, t_eval = make_trainer(tcfg, learning_rate=3e-3)
    jts, tts = j_init(jdp.params), t_init(tdp.params)
    replay = JReplay(3, 1, seed=0)
    replay.add_transitions(s, a, ns)
    batches = [b for _ in range(6) for b in replay.minibatches(64, ensemble)][:20]
    assert len(batches) == 20
    for bs, ba, bns in batches:
        jts, jl = j_step(jts, jstats, bs, ba, bns)
        tts, tl = t_step(tts, tdp.stats, *(torch.as_tensor(x) for x in (bs, ba, bns)))
        np.testing.assert_allclose(tl.numpy(), np.atleast_1d(np.asarray(jl)),
                                   rtol=BF16_LOSS_RTOL if dtype == "bfloat16" else LOSS_RTOL)
    assert tts.step == int(jts.step) == 20
    if dtype == "float32":
        assert_params_close(tts.params, np_params(jts.params), PARAM_ATOL)
        bs, ba, bns = batches[0]
        np.testing.assert_allclose(
            t_eval(tts.params, tdp.stats, *(torch.as_tensor(x) for x in (bs, ba, bns))).numpy(),
            np.atleast_1d(np.asarray(j_eval(jts.params, jstats, bs, ba, bns))), rtol=LOSS_RTOL)


# SGD through make_trainer(optimizer=) against optax.sgd: the same weights, batches and rate,
# 5 steps, parameters and losses within 1e-5 (plain SGD has no division to amplify the order of
# the float32 reductions).
SGD_TOL = 1e-5


def test_optimizer_factory_of_adam_trains_as_learning_rate():
    """``optimizer=`` a factory of ``Adam(lr=1e-2)`` with the default betas and eps trains
    bit for bit as ``learning_rate=1e-2``."""
    from blackbox_mpc_torch.learning.trainer import ADAM_BETAS, ADAM_EPS

    _, cfg = configs(3)
    dp = DynamicsHandler(cfg, seed=4, device="cpu").dynamics_params
    s, a, ns = transitions(256, 5)
    batches = [tuple(torch.as_tensor(x[i * 32:(i + 1) * 32][None].repeat(3, 0))
                     for x in (s, a, ns)) for i in range(5)]
    runs = []
    for kwargs in ({"learning_rate": 1e-2},
                   {"optimizer": lambda p: torch.optim.Adam(p, lr=1e-2, betas=ADAM_BETAS,
                                                            eps=ADAM_EPS)}):
        init, step, _ = make_trainer(cfg, **kwargs)
        ts = init(dp.params)
        losses = [step(ts, dp.stats, *b)[1] for b in batches]
        assert isinstance(ts.optimizer, torch.optim.Adam) and ts.step == 5
        runs.append(losses + flat_params(ts.params))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_optimizer_factory_of_sgd_matches_optax_sgd():
    """An SGD factory over the flat parameters matches JAX's ``make_trainer(optimizer=
    optax.sgd(lr))`` for 5 steps on the same weights and batches, at SGD_TOL."""
    import optax

    jcfg, tcfg = configs(2)
    jdp = jmodels.make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(2))
    s, a, ns = transitions(300, 9)
    jstats = jmodels.fit_normalizer(jnp.asarray(s), jnp.asarray(a), jnp.asarray(ns - s))
    tdp = dynamics_params_from_numpy(np_params(jdp.params), np_stats(jstats), tcfg, device="cpu")
    j_init, j_step, _ = j_make_trainer(jcfg, optimizer=optax.sgd(0.05))
    t_init, t_step, _ = make_trainer(tcfg, optimizer=lambda p: torch.optim.SGD(p, lr=0.05))
    jts, tts = j_init(jdp.params), t_init(tdp.params)
    assert isinstance(tts.optimizer, torch.optim.SGD)
    replay = JReplay(3, 1, seed=1)
    replay.add_transitions(s, a, ns)
    batches = [b for _ in range(3) for b in replay.minibatches(64, 2)][:5]
    assert len(batches) == 5
    for bs, ba, bns in batches:
        jts, jl = j_step(jts, jstats, bs, ba, bns)
        tts, tl = t_step(tts, tdp.stats, *(torch.as_tensor(x) for x in (bs, ba, bns)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=SGD_TOL, atol=SGD_TOL)
    assert_params_close(tts.params, np_params(jts.params), SGD_TOL)


def test_trainer_refuses_what_is_not_ported():
    """Nothing is refused any more: the Gaussian NLL is ported
    (tests/test_torch_probabilistic.py), and so is ``mesh`` (data-parallel training,
    tests/test_torch_parallel.py), whose one-device mesh trains bit for bit as without it; a
    handler's ``device`` must be the mesh's."""
    cfg = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(8,), probabilistic=True)
    dp = DynamicsHandler(cfg, device="cpu").dynamics_params
    s, a, ns = (torch.rand(1, 4, d, generator=torch.Generator().manual_seed(d))
                for d in (3, 1, 3))
    mesh = make_pop_mesh(device="cpu")
    results = []
    for m in (None, mesh):
        init, step, _ = make_trainer(cfg, mesh=m)
        ts, losses = step(init(dp.params), dp.stats, s, a, ns)
        assert losses.shape == (1,)
        results.append([losses] + flat_params(ts.params))
    for x, y in zip(*results):
        assert torch.equal(x, y)
    assert DynamicsHandler(configs(1)[1], device="cpu", mesh=mesh).device == mesh.device
    with pytest.raises(ValueError, match="device of the mesh"):
        DynamicsHandler(configs(1)[1], device="meta", mesh=mesh)


# ------------------------------------------------------------------ handler.train


def rollouts(n_episodes=4, steps=40, seed=0, noise=False):
    """Per-episode [T+1, S] observations and [T, U] actions of a random pendulum, or with
    ``noise`` of i.i.d. normal observations (nothing to learn: early stopping ends soon)."""
    rng = np.random.default_rng(seed)
    obs, acts = [], []
    for _ in range(n_episodes):
        a = rng.uniform(-2, 2, (steps, 1)).astype(np.float32)
        if noise:
            obs.append(rng.normal(size=(steps + 1, 3)).astype(np.float32))
            acts.append(a)
            continue
        th = rng.uniform(-np.pi, np.pi)
        s = [np.array([np.cos(th), np.sin(th), rng.uniform(-1, 1)], np.float32)]
        for t in range(steps):
            s.append(np.asarray(jmodels.pendulum_dynamics(jnp.asarray(s[-1][None]),
                                                          jnp.asarray(a[t][None])))[0])
        obs.append(np.stack(s))
        acts.append(a)
    return obs, acts


# (ensemble, patience, learning rate, noise data). With patience on noise data the members'
# validation losses go up and down apart, so the per-member selection mixes epochs; at a tiny
# learning rate no member improves by 1 %, so training stops after 1 + patience epochs.
@pytest.mark.parametrize("ensemble,patience,lr,noise", [
    (1, None, 1e-2, False), (5, None, 1e-2, False), (5, 2, 1e-2, True), (5, 2, 1e-6, False)])
def test_handler_train_matches_jax(ensemble, patience, lr, noise):
    jh, th = bridged(ensemble, learning_rate=lr)
    obs, acts = rollouts(noise=noise)
    epochs = 12 if patience else 3
    for call in range(2):  # the second call keeps the stats fitted by the first
        jm = jh.train(obs if call == 0 else None, acts if call == 0 else None, epochs=epochs,
                      batch_size=32, patience=patience)
        tm = th.train(obs if call == 0 else None, acts if call == 0 else None, epochs=epochs,
                      batch_size=32, patience=patience)
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL)
        for k in ("replay_size", "train_calls", "epochs_ran"):
            assert tm[k] == jm[k], k
        if lr < 1e-4:
            assert tm["epochs_ran"] == 1 + patience  # early stopping took effect
        # The planning params: the per-member bests with patience, else the last weights.
        assert_params_close(th.dynamics_params.params, np_params(jh.dynamics_params.params),
                            PARAM_ATOL)
        for f in STATS_FIELDS:
            np.testing.assert_allclose(getattr(th.dynamics_params.stats, f).numpy(),
                                       np.asarray(getattr(jh.dynamics_params.stats, f)),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model", ["learned", "learned delta off", "true model"])
def test_handler_predict_and_processing_match_jax(model):
    """``predict``, ``process_input`` and ``process_output`` of a handler with fitted stats
    (one ``train()``) against the JAX handler's, on the same weights, at LOSS_RTOL."""
    if model == "true model":
        jh = JHandler(true_model=jmodels.pendulum_dynamics)
        th = DynamicsHandler(true_model=tmodels.pendulum_dynamics, device="cpu")
    else:
        import dataclasses

        jcfg, tcfg = (dataclasses.replace(c, predict_delta=model == "learned")
                      for c in configs(3))
        jh = JHandler(config=jcfg, seed=3)
        th = DynamicsHandler(tcfg, seed=3, device="cpu")
        obs, acts = rollouts(2, 20)
        jh.train(obs, acts, epochs=1, batch_size=32)
        th.train(obs, acts, epochs=1, batch_size=32)
        dp = jh.dynamics_params
        th.set_params(dynamics_params_from_numpy(np_params(dp.params), np_stats(dp.stats),
                                                 th.config, device="cpu"))
    s, a, ns = transitions(37, 5)  # 37 rows: the batch need not divide the ensemble
    for name, args in (("predict", (s, a)), ("process_input", (s, a)),
                       ("process_output", (s, ns - s))):
        got = getattr(th, name)(*args)
        assert torch.is_tensor(got) and got.device == th.device
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jh, name)(*args)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)


def test_handler_planning_params_do_not_alias_training():
    _, th = bridged(5)
    obs, acts = rollouts(2, 20)
    th.train(obs, acts, epochs=4, batch_size=16, patience=1)
    planning = th.dynamics_params
    trainable = {id(t) for layer in th.train_state.params for t in layer.values()}
    assert not any(id(t) in trainable or t.requires_grad
                   for layer in planning.params for t in layer.values())
    snapshot = [{k: v.clone() for k, v in layer.items()} for layer in planning.params]
    th.train(epochs=2, batch_size=16)  # Adam steps the trainable copies in place
    for old, layer in zip(snapshot, planning.params):
        for k in old:
            assert torch.equal(old[k], layer[k])
    assert th.dynamics_params is not planning


def test_handler_metrics_writer_and_errors():
    from blackbox_mpc_torch.utils.metrics import MetricsWriter

    writer = MetricsWriter()
    th = DynamicsHandler(configs(1)[1], device="cpu", metrics_writer=writer)
    with pytest.raises(RuntimeError, match="replay buffer is empty"):
        th.train()
    obs, acts = rollouts(1, 10)
    with pytest.raises(ValueError, match="patience"):
        th.train(obs, acts, patience=0)
    th.train(epochs=1)
    assert set(writer.history) == {"system_model/train_loss", "system_model/val_loss"}
    true = DynamicsHandler(true_model=tmodels.pendulum_dynamics, device="cpu")
    with pytest.raises(RuntimeError, match="true-model"):
        true.train()
    with pytest.raises(RuntimeError, match="nothing to save"):
        true.save("unused")


# ------------------------------------------------------------------ checkpoints


def test_checkpoint_round_trip_then_training_continues(tmp_path):
    _, th = bridged(5)
    obs, acts = rollouts()
    th.train(obs, acts, epochs=2, batch_size=32)
    th.save(str(tmp_path / "ckpt"))
    meta = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    assert meta["format_version"] == 1 and meta["config"]["compute_dtype"] == "float32"
    assert meta["replay_keys"] == sorted(th.replay.state_dict())
    loaded = DynamicsHandler.load(str(tmp_path / "ckpt"), device="cpu")
    assert loaded.train_state.step == th.train_state.step
    for a, b in zip(th.train_state.optimizer.state_dict()["state"].values(),
                    loaded.train_state.optimizer.state_dict()["state"].values()):
        for k in a:
            assert torch.equal(a[k], b[k])
    for k, v in th.replay.state_dict().items():
        np.testing.assert_array_equal(loaded.replay.state_dict()[k], v)
    more_obs, more_acts = rollouts(1, 30, seed=5)
    m1 = th.train(more_obs, more_acts, epochs=2, batch_size=32)
    m2 = loaded.train(more_obs, more_acts, epochs=2, batch_size=32)
    assert m1 == m2  # the same numbers, bit for bit: training continued as if uninterrupted
    for a, b in zip(th.dynamics_params.params, loaded.dynamics_params.params):
        for k in a:
            assert torch.equal(a[k], b[k])
    meta["format_version"] = 2
    (tmp_path / "ckpt" / "config.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format_version"):
        DynamicsHandler.load(str(tmp_path / "ckpt"), device="cpu")


@pytest.mark.parametrize("ensemble", [1, 5])
def test_jax_checkpoint_crosses_over(tmp_path, ensemble):
    jh, _ = bridged(ensemble)
    obs, acts = rollouts()
    jh.train(obs, acts, epochs=2, batch_size=32)
    jh.save(str(tmp_path / "jax"))
    jl = JHandler.load(str(tmp_path / "jax"))
    meta = json.loads((tmp_path / "jax" / "config.json").read_text())
    ts = jl._train_state
    th = handler_from_numpy(meta, np_params(ts.params), np_params(ts.opt_state),
                            np.asarray(ts.step), np_stats(jl.dynamics_params.stats),
                            jl.replay.state_dict(), device="cpu")
    assert th.train_state.step == int(ts.step)
    more_obs, more_acts = rollouts(1, 30, seed=5)
    jm = jl.train(more_obs, more_acts, epochs=2, batch_size=32)
    tm = th.train(more_obs, more_acts, epochs=2, batch_size=32)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL)
    assert tm["replay_size"] == jm["replay_size"] and tm["train_calls"] == jm["train_calls"]
    assert_params_close(th.dynamics_params.params, np_params(jl.dynamics_params.params),
                        PARAM_ATOL)
    assert os.path.exists(tmp_path / "jax" / "checkpoint")
