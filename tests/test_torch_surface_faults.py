"""The port's public surface where it differed from the JAX package's: ``.replace`` on
``Bounds``, ``NormalizerStats`` and ``TrainState`` (a replaced ``Bounds`` must not carry the old
box's device tensors into the solvers and the fused kernels), ``adam_polish(optimizer)``,
``export_dynamics(platforms=)``, JAX's positional order of ``MPCPolicy``,
``DynamicsHandler`` and ``ServingPolicy.load``, and JAX's backend names ``"xla"`` and
``"pallas"``.

Inputs are made with numpy from a seed; the JAX side runs on the CPU. Tolerances: the
normalizer 1e-6 relative; three Adam steps after ``TrainState.replace`` 1e-5 relative (atol
1e-6); ``adam_polish`` against optax 1e-5 (atol 1e-5, as ``test_torch_first_order.py``
holds it); the exported dynamics 1e-6. Where one
side is the port against itself (a replaced ``Bounds`` against a fresh one, an alias against
its backend, the float polish against the digest of the earlier signature's result) the
comparison is bit for bit.
"""
import dataclasses
import hashlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blackbox_mpc_torch.learning.trainer as trainer_mod
import blackbox_mpc_torch.ops.fused_cem as tc
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.learning.trainer import make_trainer as j_make_trainer
from blackbox_mpc_tpu.models import dynamics as jdyn
from blackbox_mpc_tpu.models.normalizer import NormalizerStats as JStats
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.deploy import ServingPolicy, export_dynamics, export_policy_artifact
from blackbox_mpc_torch.learning.trainer import flat_params, make_trainer
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS, NormalizerStats
from blackbox_mpc_torch.parallel import make_pop_mesh
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.solvers import make_solver
from blackbox_mpc_torch.solvers.cem import CEMConfig
from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig
from blackbox_mpc_torch.utils.metrics import MetricsWriter

S, U = 3, 2
OLD = (np.full(U, -1.0, np.float32), np.full(U, 1.0, np.float32))
NEW = (np.asarray([-0.2, 0.1], np.float32), np.asarray([0.6, 0.9], np.float32))
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_bits(a, b) -> bool:
    a, b = (np.asarray(x.detach().numpy() if torch.is_tensor(x) else x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def digest(arrays) -> str:
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(x.detach().numpy() if torch.is_tensor(x) else x).tobytes())
    return h.hexdigest()


def used_bounds() -> Bounds:
    """``Bounds`` of the old box whose device cache holds every entry a solve reads."""
    b = Bounds(*OLD)
    b.on("cpu")
    for name in ("midpoint", "default_variance"):
        b.constant(name, "cpu")
    return b


# --- Bounds ---------------------------------------------------------------------------------

REPLACERS = {"method": lambda b, **kw: b.replace(**kw),
             "dataclasses.replace": lambda b, **kw: dataclasses.replace(b, **kw)}


@pytest.mark.parametrize("how", list(REPLACERS))
def test_replaced_bounds_read_the_new_box_after_the_old_cache_filled(how):
    b = used_bounds()
    r = REPLACERS[how](b, lower=NEW[0], upper=NEW[1])
    lower, upper = r.on("cpu")
    assert same_bits(lower, NEW[0]) and same_bits(upper, NEW[1])
    x = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (5, U)), dtype=torch.float32)
    assert same_bits(r.clip(x), torch.clamp(x, torch.as_tensor(NEW[0]), torch.as_tensor(NEW[1])))
    assert same_bits(r.constant("midpoint", "cpu"), (NEW[0] + NEW[1]) / 2)
    assert same_bits(r.constant("default_variance", "cpu"), np.square(NEW[1] - NEW[0]) / 16)
    assert same_bits(b.on("cpu")[1], OLD[1])  # the old Bounds keeps its box


def test_bounds_replace_matches_jax():
    j = JBounds.of(-1.0, 1.0, dim=U).replace(lower=jnp.asarray(NEW[0]), upper=jnp.asarray(NEW[1]))
    t = used_bounds().replace(lower=NEW[0], upper=NEW[1])
    for name in ("lower", "upper", "midpoint", "default_variance"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)))


def test_bounds_constructor_takes_no_cache_as_jax():
    with pytest.raises(TypeError):
        JBounds(jnp.zeros(U), jnp.ones(U), _tensors={})
    with pytest.raises(TypeError):
        Bounds(np.zeros(U, np.float32), np.ones(U, np.float32), _tensors={})


def test_a_pickled_bounds_carries_no_cache():
    b = used_bounds()
    blob = pickle.dumps(b)
    assert b"_tensors" not in blob
    back = pickle.loads(blob)
    assert back._tensors == {} and same_bits(back.lower, OLD[0])
    assert same_bits(back.on("cpu")[0], OLD[0])


def quadratic_evaluator(target: np.ndarray):
    goal = torch.as_tensor(target)

    def evaluate(obs, plans):  # [A, S], [P, A, H, U] -> [P, A]
        return -torch.square(plans - goal).sum(dim=(2, 3)) + obs.sum(-1)
    return evaluate


EAGER = {"CEM": dict(population=32, num_elite=4, max_iterations=3),
         "PSO": dict(population=16, max_iterations=3),
         "RandomSearch": dict(population=32)}


@pytest.mark.parametrize("name", list(EAGER))
def test_eager_solve_on_replaced_bounds_is_a_fresh_bounds_solve(name):
    evaluate = quadratic_evaluator(np.asarray([0.9, -0.4], np.float32))
    kw = dict(planning_horizon=5, num_agents=2, **EAGER[name])
    obs = torch.as_tensor(np.random.default_rng(1).normal(size=(2, S)), dtype=torch.float32)
    old = used_bounds()
    warm = make_solver(name, old, evaluate, **kw)
    warm.solve(warm.init(torch.Generator().manual_seed(0)), obs, 0,
               torch.Generator().manual_seed(1))
    outs = []
    for bounds in (old.replace(lower=NEW[0], upper=NEW[1]), Bounds(*NEW)):
        solver = make_solver(name, bounds, evaluate, **kw)
        action, state, aux = solver.solve(solver.init(torch.Generator().manual_seed(2)), obs, 0,
                                          torch.Generator().manual_seed(3))
        outs.append([action, aux.plan, aux.expected_reward,
                     *(v for v in vars(state).values() if torch.is_tensor(v))])
    for got, want in zip(*outs):
        assert same_bits(got, want)
    action = outs[0][0].numpy()
    assert np.all(action >= NEW[0]) and np.all(action <= NEW[1])


def t_reward(s, a, ns):
    return -torch.square(ns).sum(-1) - 0.1 * torch.square(a).sum(-1)


FUSED = {"CEM": (tc.make_fused_cem, CEMConfig(planning_horizon=4, num_agents=2, population=16,
                                              num_elite=4, max_iterations=2)),
         "RandomSearch": (tc.make_fused_random_search,
                          RandomSearchConfig(planning_horizon=4, num_agents=2, population=16))}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_solve_on_replaced_bounds_is_a_fresh_bounds_solve(name):
    """The fused family on CPU tensors (the kernels' plain versions): K4 clips to the numpy
    box, the mean clip and the uniform draw read the cache; both must be the new box."""
    make, config = FUSED[name]
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,), ensemble_size=2)
    dp = tdyn.make_learned_dynamics(cfg)[0](torch.Generator().manual_seed(0))
    obs = torch.as_tensor(np.random.default_rng(2).normal(size=(2, S)), dtype=torch.float32)
    old = used_bounds()
    warm = make(config, old, cfg, dp, t_reward)
    warm.solve(warm.init(torch.Generator()), obs, 0, torch.Generator().manual_seed(1))
    outs = []
    for bounds in (old.replace(lower=NEW[0], upper=NEW[1]), Bounds(*NEW)):
        solver = make(config, bounds, cfg, dp, t_reward)
        action, state, aux = solver.solve(solver.init(torch.Generator()), obs, 0,
                                          torch.Generator().manual_seed(4))
        outs.append([action, aux.plan, aux.expected_reward,
                     *(v for v in vars(state).values() if torch.is_tensor(v))])
    for got, want in zip(*outs):
        assert same_bits(got, want)
    plan = outs[0][1].numpy()
    assert np.all(plan >= NEW[0]) and np.all(plan <= NEW[1])


# --- NormalizerStats and TrainState ---------------------------------------------------------


def test_normalizer_stats_replace_matches_jax():
    rng = np.random.default_rng(3)
    fields = {f: rng.uniform(0.5, 2.0, S if "actions" not in f else U).astype(np.float32)
              for f in STATS_FIELDS}
    std = rng.uniform(0.1, 3.0, S).astype(np.float32)
    j = JStats(**{f: jnp.asarray(v) for f, v in fields.items()}).replace(
        std_states=jnp.asarray(std))
    t = NormalizerStats(**{f: torch.as_tensor(v) for f, v in fields.items()}).replace(
        std_states=torch.as_tensor(std))
    x = rng.normal(size=(7, S)).astype(np.float32)
    np.testing.assert_allclose(t.normalize_states(torch.as_tensor(x)).numpy(),
                               np.asarray(j.normalize_states(jnp.asarray(x))), rtol=1e-6)


def trainer_pair():
    jcfg = jdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=2)
    tcfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=2)
    rng = np.random.default_rng(5)
    stats = {f: rng.uniform(0.5, 1.5, U if "actions" in f else S).astype(np.float32)
             for f in STATS_FIELDS}
    jstats = JStats(**{f: jnp.asarray(v) for f, v in stats.items()})
    weights = [jax.tree_util.tree_map(np.asarray, jdyn.make_learned_dynamics(jcfg)[0](
        jax.random.PRNGKey(k)).params) for k in (1, 2)]
    tdps = [dynamics_params_from_numpy(w, stats, tcfg, device="cpu") for w in weights]
    batches = [tuple(rng.normal(size=(2, 32, d)).astype(np.float32) for d in (S, U, S))
               for _ in range(5)]
    return (j_make_trainer(jcfg, learning_rate=1e-2), make_trainer(tcfg, learning_rate=1e-2),
            jstats, tdps[0].stats, weights, [dp.params for dp in tdps], batches)


def test_train_state_replace_params_trains_the_new_leaves_as_jax():
    """Two steps on one set of weights, ``replace(params=)`` with another, three more steps:
    the Adam moments carry over by position on both sides."""
    (j_init, j_step, _), (t_init, t_step, _), jstats, tstats, jw, tw, batches = trainer_pair()
    jts, tts = j_init(jw[0]), t_init(tw[0])
    for b in batches[:2]:
        jts, _ = j_step(jts, jstats, *b)
        tts, _ = t_step(tts, tstats, *map(torch.as_tensor, b))
    jts = jts.replace(params=jw[1])
    before = [p.detach().clone() for p in flat_params(tts.params)]
    new = tts.replace(params=tw[1])
    assert new.step == tts.step == 2 and new.optimizer is not tts.optimizer
    for b in batches[2:]:
        jts, _ = j_step(jts, jstats, *b)
        new, _ = t_step(new, tstats, *map(torch.as_tensor, b))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jts.params))
    got = flat_params(new.params)
    for g, w in zip(got, [x for layer in jts.params for x in (layer["w"], layer["b"])]):
        np.testing.assert_allclose(g.detach().numpy().reshape(np.shape(w)), np.asarray(w),
                                   rtol=TOL, atol=1e-6)
    assert len(got) == len(want)
    for old, kept in zip(flat_params(tts.params), before):  # the old state is untouched
        assert torch.equal(old, kept)
    assert all(not torch.equal(g.detach(), t) for g, t in zip(got, flat_params(tw[1])))


def test_train_state_replace_never_steps_the_callers_tensors():
    """Params taken from another state (trainable leaves) or from the state itself: steps of
    the replaced state leave both states' tensors as they were."""
    _, (t_init, t_step, _), _, tstats, _, tw, batches = trainer_pair()
    ts_a, ts_b = t_init(tw[0]), t_init(tw[1])
    kept = {k: [p.detach().clone() for p in flat_params(s.params)]
            for k, s in (("a", ts_a), ("b", ts_b))}
    for k, source in (("b", ts_b), ("a", ts_a)):
        new = ts_a.replace(params=source.params)
        assert not set(map(id, flat_params(new.params))) & set(
            map(id, flat_params(ts_a.params) + flat_params(ts_b.params)))
        for b in batches[:2]:
            new, _ = t_step(new, tstats, *map(torch.as_tensor, b))
        assert not all(torch.equal(g.detach(), t)
                       for g, t in zip(flat_params(new.params), kept[k]))
    for k, s in (("a", ts_a), ("b", ts_b)):
        assert all(torch.equal(p, w) for p, w in zip(flat_params(s.params), kept[k]))


def test_train_state_replace_step_keeps_the_optimizer_and_refuses_unknown_fields():
    _, (t_init, _, _), _, _, _, tw, _ = trainer_pair()
    ts = t_init(tw[0])
    moved = ts.replace(step=7)
    assert moved.step == 7 and moved.optimizer is ts.optimizer and moved.params is ts.params
    with pytest.raises(TypeError):
        ts.replace(opt_state=None)


def test_train_state_replace_keeps_the_mesh_all_reduce(monkeypatch):
    """A replaced state trains through the same ``make_trainer`` closure: with a mesh, every
    step still sums its gradients over the ranks."""
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,), ensemble_size=2)
    calls = []
    monkeypatch.setattr(trainer_mod, "all_reduce_sum",
                        lambda mesh, x: calls.append(x.numel()) or x)
    init, step, _ = make_trainer(cfg, mesh=make_pop_mesh(device="cpu"))
    dps = [tdyn.make_learned_dynamics(cfg)[0](torch.Generator().manual_seed(k)) for k in (0, 1)]
    ts = init(dps[0].params).replace(params=dps[1].params)
    b = [torch.randn((2, 16, d), generator=torch.Generator().manual_seed(d)) for d in (S, U, S)]
    step(ts, dps[1].stats, *b)
    assert len(calls) == 1


# --- adam_polish ----------------------------------------------------------------------------


def polish_problem():
    """A learned 2-member ensemble, a quadratic reward, plans and bounds, all seeded."""
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=2)
    dp = tdyn.make_learned_dynamics(cfg)[0](torch.Generator().manual_seed(6))
    fn = tdyn.make_learned_dynamics(cfg)[1]
    from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

    ev = make_trajectory_evaluator(lambda s, a: fn(dp, s, a), t_reward, device="cpu")
    rng = np.random.default_rng(7)
    obs = torch.as_tensor(rng.normal(size=(2, S)), dtype=torch.float32)
    plans = torch.as_tensor(rng.uniform(-0.9, 0.9, (4, 2, 6, U)), dtype=torch.float32)
    return (lambda p: ev(obs, p)), Bounds.of(-1.0, 1.0, dim=U), plans


# SHA-256 of the float path's plans, of one Gradient and one CEM-GD act() (action, predicted
# next observation and reward) on the seeded inputs below, as the port computed them before
# adam_polish took JAX's optimizer argument (one intra-op thread).
PARENT_DIGESTS = {
    "adam_polish":
        "c06f3e7af6b13bf7ee88adc84097d10c3046a370b70e20686a739ab0685826d2",
    "Gradient":
        "5b768b04210f7f35b5be1dab35d6f576837c2dd133b3ddef5cf16bc0157d07b3",
    "CEM-GD":
        "46ab0245d2b497d1f00e96420bd1e55c39e624ba0e4b7863d975e7d3161e2513",
}
FIRST_ORDER = {"Gradient": dict(planning_horizon=8, population=6, max_iterations=5,
                                learning_rate=0.2),
               "CEM-GD": dict(planning_horizon=6, population=24, num_elite=6, max_iterations=3,
                              gd_candidates=3, gd_iterations=4)}


def float_polish_digest() -> str:
    evaluate, bounds, plans = polish_problem()
    return digest([tbase.adam_polish(evaluate, bounds, 0.1, plans, 6)])


def first_order_act_digest(name: str) -> str:
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=2)
    handler = DynamicsHandler(cfg, seed=0, device="cpu")
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler, name, 2, seed=3,
                       device="cpu", **FIRST_ORDER[name])
    obs = np.random.default_rng(8).normal(size=(2, S)).astype(np.float32)
    return digest(policy.act(obs))


def test_adam_polish_float_path_gives_the_earlier_bits():
    assert float_polish_digest() == PARENT_DIGESTS["adam_polish"]


@pytest.mark.parametrize("name", list(FIRST_ORDER))
def test_first_order_act_gives_the_earlier_bits(name):
    assert first_order_act_digest(name) == PARENT_DIGESTS[name]


OPTIMIZERS = {"float": (0.1, optax.adam(0.1)),
              "SGD callable": (lambda ps: torch.optim.SGD(ps, lr=0.1), optax.sgd(0.1)),
              "Adam callable": (lambda ps: torch.optim.Adam(ps, lr=0.1, betas=(0.9, 0.999),
                                                            eps=1e-8), optax.adam(0.1))}


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_adam_polish_optimizer_matches_optax(kind):
    """JAX's argument name and both forms: a float (optax.adam) and a callable making a
    ``torch.optim`` optimizer (optax.sgd, optax.adam), on the same quadratic objective and
    clip."""
    rng = np.random.default_rng(9)
    goal = rng.uniform(-1.5, 1.5, (2, 6, U)).astype(np.float32)
    plans = rng.uniform(-0.5, 0.5, (4, 2, 6, U)).astype(np.float32)
    port_opt, jax_opt = OPTIMIZERS[kind]
    for steps in (1, 5):
        want = jbase.adam_polish(lambda p: -jnp.sum(jnp.square(p - goal), axis=(2, 3)),
                                 JBounds.of(-1.0, 1.0, dim=U), jax_opt, jnp.asarray(plans),
                                 steps)
        got = tbase.adam_polish(
            lambda p: -torch.square(p - torch.as_tensor(goal)).sum(dim=(2, 3)),
            Bounds.of(-1.0, 1.0, dim=U), optimizer=port_opt, plans=torch.as_tensor(plans),
            iterations=steps)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# --- export_dynamics(platforms=) ------------------------------------------------------------


def learned_handler():
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=2)
    return DynamicsHandler(cfg, seed=1, device="cpu")


def test_export_dynamics_platforms_cpu_predicts_as_the_handler(tmp_path):
    handler = learned_handler()
    path = str(tmp_path / "dyn.pt2")
    export_dynamics(handler, path, platforms=("cpu",))
    restored = torch.export.load(path).module()
    for b in (1, 37):
        g = np.random.default_rng(b)
        s = torch.as_tensor(g.normal(size=(b, S)), dtype=torch.float32)
        a = torch.as_tensor(g.normal(size=(b, U)), dtype=torch.float32)
        want = handler.mean_dynamics_fn(handler.dynamics_params, s, a)
        torch.testing.assert_close(restored(s, a), want, rtol=1e-6, atol=1e-6)


def test_export_dynamics_refuses_platforms_it_cannot_make(monkeypatch):
    handler = learned_handler()
    with pytest.raises(ValueError, match="platforms"):
        export_dynamics(handler, platforms=("tpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        export_dynamics(handler, platforms=("cuda",))


# --- JAX's positional order and backend names -----------------------------------------------


def test_mpc_policy_takes_jax_positional_order():
    writer = MetricsWriter(tensorboard=False)
    handler = DynamicsHandler(true_model=lambda s, a: s, device="cpu")
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler, "CEM", 1, 10, 0.05,
                       1.0, 0, writer, device="cpu", population=16, num_elite=4,
                       max_iterations=1)
    policy.act(np.zeros(S, np.float32))
    assert list(writer.history) == ["rewards/predicted_reward"]


def test_dynamics_handler_takes_jax_positional_order(monkeypatch):
    calls = []
    monkeypatch.setattr(trainer_mod, "all_reduce_sum",
                        lambda mesh, x: calls.append(x.numel()) or x)
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,), ensemble_size=2)
    mesh = make_pop_mesh(device="cpu")
    handler = DynamicsHandler(cfg, None, 1e-3, 0.2, False, None, None, None, 1, 0, mesh)
    assert handler.device == mesh.device
    rng = np.random.default_rng(10)
    s = rng.normal(size=(64, S)).astype(np.float32)
    a = rng.normal(size=(64, U)).astype(np.float32)
    handler.replay.add_transitions(s, a, s + 0.1 * rng.normal(size=(64, S)).astype(np.float32))
    handler.train(epochs=1, batch_size=16)
    assert calls  # the mesh's all-reduce ran: the eleventh argument is the mesh


def test_serving_policy_load_takes_jax_positional_order(tmp_path):
    """JAX's ``ServingPolicy.load(path, compiled_cache)``: the second positional argument is
    the cache (a missing one is ignored with a warning), not the port's device."""
    handler = DynamicsHandler(true_model=lambda s, a: s + 0.1 * a.sum(-1, keepdim=True),
                              device="cpu")
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler, device="cpu",
                       planning_horizon=4, population=16, num_elite=4, max_iterations=1)
    path = str(tmp_path / "policy.bbmpc")
    export_policy_artifact(policy, path, dim_s=S)
    with pytest.warns(RuntimeWarning, match="ignoring compiled cache"):
        served = ServingPolicy.load(path, str(tmp_path / "missing.cache"), device="cpu")
    assert not served.used_compiled_cache


@pytest.mark.parametrize("jax_name,port_name", [("xla", "eager"), ("pallas", "kernel")])
def test_jax_backend_names_build_the_port_backend(jax_name, port_name):
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,), ensemble_size=2)
    obs = np.random.default_rng(11).normal(size=S).astype(np.float32)
    outs = []
    for name in (jax_name, port_name):
        handler = DynamicsHandler(cfg, seed=2, device="cpu")
        policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler,
                           rollout_backend=name, device="cpu", planning_horizon=5,
                           population=16, num_elite=4, max_iterations=2)
        assert policy.rollout_backend == port_name
        outs.append(policy.act(obs))
    for got, want in zip(*outs):
        assert same_bits(got, want)
