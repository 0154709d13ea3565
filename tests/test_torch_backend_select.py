"""``rollout_backend="auto"`` of the port (``ops/backend_select.py``) against the JAX package's
``choose_backend``: every configuration JAX routes to XLA for a gate goes to ``"eager"``, every
backend the port resolves constructs, ``auto`` on the CPU is the eager policy bit for bit, and
``switch_solver`` resolves again. Small sizes: H <= 8, hidden (16, 16), E = 2."""
import dataclasses
import itertools
import logging
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.backend_select as jsel
import blackbox_mpc_torch.ops.backend_select as tsel
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.solvers import SOLVER_REGISTRY as J_REGISTRY
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models.latent import LatentModelConfig
from blackbox_mpc_torch.models.rssm import RSSMConfig
from blackbox_mpc_torch.models.vjepa2_ac import VJEPA2ACConfig
from blackbox_mpc_torch.parallel import PopMesh
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY

torch.set_num_threads(1)

S, U, H, E = 3, 1, 6, 2
TIME_MAJOR = ("CEM", "CEM-GD", "PI2", "MPPI", "PSO", "RandomSearch", "SPSA")
# (probabilistic, propagation) of the learned configurations; None is the true model.
KINDS = [None, (False, "mean"), (False, "ts1"), (True, "mean"), (True, "ts_inf"),
         (True, "mm")]
ACTIVATIONS = ("tanh", "relu", "swish")
DTYPES = ("float32", "bfloat16")


def t_reward(s, a, ns):
    return -torch.sum(torch.square(ns), dim=-1) - 0.1 * torch.sum(torch.square(a), dim=-1)


def configs(kind, activation, dtype):
    if kind is None:
        return None, None
    probabilistic, propagation = kind
    common = dict(dim_s=S, dim_u=U, hidden=(16, 16), ensemble_size=E, activation=activation,
                  probabilistic=probabilistic, propagation=propagation)
    return (JConfig(**common, compute_dtype=getattr(jnp, dtype)),
            LearnedDynamicsConfig(**common, compute_dtype=getattr(torch, dtype)))


def solver_config(registry, name, population, time_major=False, **kw):
    config_cls = registry[name][0]
    kw = {k: v for k, v in kw.items() if k in config_cls.__dataclass_fields__}
    if time_major:
        kw["time_major"] = True
    if "num_elite" in config_cls.__dataclass_fields__:
        kw["num_elite"] = 4
    if name == "CMA-ES":
        kw["diagonal"] = True
    return config_cls(planning_horizon=H, population=population, **kw)


GRID = [(kind, act, dtype, name, tm, pop)
        for kind, act, dtype in itertools.product(KINDS, ACTIVATIONS, DTYPES)
        for name in sorted(SOLVER_REGISTRY)
        for tm in ((False, True) if name in TIME_MAJOR else (False,))
        for pop in (16, 2**30)]


@pytest.fixture
def open_regimes(monkeypatch):
    """Both packages' regimes opened (their measured constants shut JAX's on a v5e): JAX's
    answer is then "xla" exactly where a gate refuses the kernels."""
    monkeypatch.setattr(jsel, "PALLAS_MAX_WIDTH", 10**6)
    monkeypatch.setattr(jsel, "PALLAS_MAX_ROWS", 10**12)
    monkeypatch.setattr(jsel, "FUSED_CEM_MIN_BYTES", 0)
    monkeypatch.setattr(tsel, "KERNEL_MAX_WIDTH", 10**6)
    monkeypatch.setattr(tsel, "KERNEL_MAX_ROWS", 10**12)
    monkeypatch.setattr(tsel, "FUSED_MIN_BYTES", 0)


def answers(kind, act, dtype, name, tm, pop):
    """(JAX's answer, the port's) at one grid point."""
    jcfg, tcfg = configs(kind, act, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jsel.choose_backend(jcfg, pop, 1,
                                   platform="tpu", horizon=H, dim_u=U, solver_name=name,
                                   solver_config=solver_config(J_REGISTRY, name, 16, tm))
        got = tsel.choose_backend(tcfg, pop, 1,
                                  platform="cuda", horizon=H, dim_u=U, solver_name=name,
                                  solver_config=solver_config(SOLVER_REGISTRY, name, 16, tm))
    return want, got


def port_kernels_only(kind):
    """The port's departure from JAX's gates: its rollout kernel (K2) samples PETS' ts_inf on a
    probabilistic head, with swish layers too, which JAX's Pallas kernels refuse."""
    return kind == (True, "ts_inf")


@pytest.mark.parametrize("kernel_regime", [True, False])
def test_jax_gates_route_port_to_eager(open_regimes, monkeypatch, kernel_regime):
    """On every grid point where JAX's ``choose_backend(platform="tpu")`` answers "xla", the
    port's ``choose_backend(platform="cuda")`` answers "eager": the true model, probabilistic
    heads, propagation, activation, time_major and the counter range (2**30 rows x H*U).
    Excluded are exactly the points that the port's own gates send to a kernel
    (:func:`port_kernels_only`; what they answer is checked in
    ``test_port_sends_ts_inf_to_the_kernel``)."""
    if not kernel_regime:  # the counter-range gate shows when only the fused regime is open
        monkeypatch.setattr(jsel, "PALLAS_MAX_WIDTH", 0)
        monkeypatch.setattr(tsel, "KERNEL_MAX_WIDTH", 0)
    gated = 0
    for kind, act, dtype, name, tm, pop in GRID:
        want, got = answers(kind, act, dtype, name, tm, pop)
        assert got in ("eager", "kernel", "fused")
        if want == "xla" and not (port_kernels_only(kind) and got != "eager"):
            gated += 1
            assert got == "eager", (kind, act, dtype, name, tm, pop, got)
    assert gated > len(GRID) // 2  # the grid reaches every gate


@pytest.mark.parametrize("kernel_regime", [True, False])
def test_port_sends_ts_inf_to_the_kernel(open_regimes, monkeypatch, kernel_regime):
    """The grid points that the JAX test above excludes: a probabilistic ts_inf net goes to
    "kernel" in float32 on one device, with the candidate layout [P, A, H, U], a zeroth-order
    solver and particle rows within ``KERNEL_MAX_ROWS``, and never to "fused" (its kernels
    are deterministic)."""
    if not kernel_regime:
        monkeypatch.setattr(tsel, "KERNEL_MAX_WIDTH", 0)
    kernels = 0
    for kind, act, dtype, name, tm, pop in GRID:
        if not port_kernels_only(kind):
            continue
        got = answers(kind, act, dtype, name, tm, pop)[1]
        want = "kernel" if (kernel_regime and dtype == "float32" and not tm
                            and name not in ("Gradient", "CEM-GD")) else "eager"
        assert got == want, (kind, act, dtype, name, tm, pop, got)
        kernels += got != "eager"
    assert (kernels > 0) == kernel_regime


def test_port_only_gates():
    """Gates of the port beyond JAX's: a device other than cuda, a compute dtype the kernels
    refuse, the first-order solvers; and with a mesh never "kernel" (JAX's rule for pallas)."""
    _, cfg = configs((False, "mean"), "tanh", "float32")
    kw = dict(horizon=H, dim_u=U, solver_name="CEM")
    assert tsel.choose_backend(cfg, 64, 1, platform="cuda", **kw) == "kernel"
    assert tsel.choose_backend(cfg, 64, 1, platform="cpu", **kw) == "eager"
    half = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16,), compute_dtype=torch.float16)
    assert tsel.choose_backend(half, 64, 1, platform="cuda", **kw) == "eager"
    for name in ("Gradient", "CEM-GD"):
        assert tsel.choose_backend(cfg, 64, 1, platform="cuda", horizon=H, dim_u=U,
                                   solver_name=name) == "eager"
    wide = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(tsel.KERNEL_MAX_WIDTH + 1,))
    assert tsel.choose_backend(wide, 64, 1, platform="cuda", **kw) == "eager"
    assert tsel.choose_backend(cfg, tsel.KERNEL_MAX_ROWS + 1, 1, platform="cuda",
                               **kw) == "eager"
    # ts1: the kernel evaluator needs rows divisible by E
    _, ts1 = configs((False, "ts1"), "tanh", "float32")
    assert tsel.choose_backend(ts1, 63, 1, platform="cuda", **kw) == "eager"
    assert tsel.choose_backend(ts1, 64, 1, platform="cuda", **kw) == "kernel"
    two = PopMesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    assert tsel.choose_backend(cfg, 64, 1, mesh=two, platform="cuda", **kw) == "eager"
    assert tsel.choose_backend(ts1, 64, 1, mesh=two, platform="cuda", **kw) == "eager"


def test_capacity_routes_fused_before_kernel():
    """The candidate tensor at FUSED_MIN_BYTES routes the fused family to "fused" (the kernel
    path materializes it too); sep-CMA only with diagonal=True; time_major warns and stays
    eager."""
    _, cfg = configs((False, "mean"), "tanh", "float32")
    horizon, dim_u = 50, 6
    rows = -(-tsel.FUSED_MIN_BYTES // (horizon * dim_u * 4))
    kw = dict(platform="cuda", horizon=horizon, dim_u=dim_u)
    for name in ("CEM", "PI2", "MPPI", "RandomSearch"):
        assert tsel.choose_backend(cfg, rows, 1, solver_name=name, **kw) == "fused"
        assert tsel.choose_backend(cfg, rows - 1, 1, solver_name=name, **kw) == "eager"
    cma = SOLVER_REGISTRY["CMA-ES"][0]
    assert tsel.choose_backend(cfg, rows, 1, solver_name="CMA-ES",
                               solver_config=cma(diagonal=True), **kw) == "fused"
    assert tsel.choose_backend(cfg, rows, 1, solver_name="CMA-ES", solver_config=cma(),
                               **kw) == "eager"
    assert tsel.choose_backend(cfg, rows, 1, solver_name="PSO", **kw) == "eager"
    cem = SOLVER_REGISTRY["CEM"][0]
    with pytest.warns(RuntimeWarning, match="time_major"):
        assert tsel.choose_backend(cfg, rows, 1, solver_name="CEM",
                                   solver_config=cem(time_major=True), **kw) == "eager"


@pytest.mark.parametrize("backend", ["eager", "kernel", "fused"])
def test_auto_picks_only_what_the_rules_accept(open_regimes, backend):
    """``choose_backend`` and the explicit backends read one set of rules: wherever "auto"
    (on a card, the regimes open) answers ``backend``, the resolver accepts ``backend`` asked
    for by name at that grid point."""
    picked = 0
    for kind, act, dtype, name, tm, pop in GRID:
        _, cfg = configs(kind, act, dtype)
        sc = solver_config(SOLVER_REGISTRY, name, 16, tm)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = tsel.choose_backend(cfg, pop, 1, platform="cuda", horizon=H, dim_u=U,
                                      solver_name=name, solver_config=sc)
        if got != backend:
            continue
        picked += 1
        assert tsel.resolve_backend(backend, cfg, False, name, sc, 1, H, U,
                                    platform="cuda") == backend, (kind, act, dtype, name, tm)
    assert picked > 0


# The benchmark cells' solves (port_bench/configs and port_bench/traffic), written out.
CHEETAH = LearnedDynamicsConfig(dim_s=17, dim_u=6, hidden=(500, 500, 500), activation="tanh",
                                ensemble_size=5, propagation="mean")
PETS = LearnedDynamicsConfig(dim_s=18, dim_u=6, hidden=(200, 200, 200, 200),
                             activation="swish", ensemble_size=5, propagation="ts_inf",
                             num_particles=20, probabilistic=True, learn_logvar_bounds=True)
TDMPC2_317M = LatentModelConfig(obs_dim=17, action_dim=6, latent_dim=1376, enc_dim=4096,
                                mlp_dim=4096, num_enc_layers=5, num_q=8)
DREAMERV3_200M = RSSMConfig(obs_dim=17, action_dim=6)
VJEPA2_AC_300M = VJEPA2ACConfig()
CELLS = {
    "cheetah_cem_3x500.cem_closed_loop": (
        CHEETAH, "CEM", dict(population=1000, num_elite=50, max_iterations=5, alpha=0.25,
                             warm_start=True), 50, 1.0, "kernel"),
    "cheetah_cem_3x500.random_search": (
        CHEETAH, "RandomSearch", dict(population=4048), 15, 1.0, "kernel"),
    "pets_halfcheetah.ts_inf_closed_loop": (
        PETS, "CEM", dict(population=500, num_elite=50, max_iterations=5, alpha=0.1,
                          warm_start=True), 30, 1.0, "kernel"),
    "tdmpc2_317m.latent_closed_loop": (
        TDMPC2_317M, "CEM", dict(population=512, num_elite=64, max_iterations=6, alpha=0.0,
                                 warm_start=True), 3, 0.99, "eager"),
    "dreamerv3_200m.planet_closed_loop": (
        DREAMERV3_200M, "CEM", dict(population=1000, num_elite=100, max_iterations=10,
                                    alpha=0.0), 12, 1.0, "eager"),
    "vjepa2_ac_300m.goal_cem_closed_loop": (
        VJEPA2_AC_300M, "CEM", dict(population=128, num_elite=10, max_iterations=3, alpha=0.0),
        2, 1.0, "eager"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_auto_on_the_benchmark_cells(cell):
    """"auto" on a card, at the measured regimes, resolves each benchmark cell's solve (one
    agent) to the backend its measurements were made on."""
    config, name, kwargs, horizon, discount, want = CELLS[cell]
    sc = SOLVER_REGISTRY[name][0](planning_horizon=horizon, **kwargs)
    assert tsel.resolve_backend("auto", config, False, name, sc, 1, horizon, 6,
                                discount=discount, platform="cuda") == want


# 64 units a block group, which the block kernel's 128-wide output tiles do not fit; and 128.
RSSM_SMALL = RSSMConfig(obs_dim=17, action_dim=6, deter=512, hidden=64, stoch=8, classes=16,
                        units=64)
RSSM_MID = dataclasses.replace(RSSM_SMALL, deter=1024)


@pytest.mark.parametrize("config, name, platform, refusal", [
    (DREAMERV3_200M, "CEM", "cuda", None), (RSSM_MID, "CEM", "cuda", None),
    (RSSM_SMALL, "CEM", "cuda", "tiles a layer's inputs by 32 and its outputs by 128"),
    (RSSM_SMALL, "CEM", "cpu", None),
    (RSSM_MID, "Gradient", "cuda", "no backward"), (RSSM_MID, "CEM-GD", "cuda", "no backward"),
    (RSSM_MID, "Gradient", "cpu", None),
], ids=["200m", "mid", "small", "small-cpu", "gradient", "cem-gd", "gradient-cpu"])
def test_an_rssm_on_the_card_needs_tiled_blocks_and_no_backward(config, name, platform,
                                                                 refusal):
    """On the card the RSSM's block layers run on the block kernel, which has no fallback and
    no backward: "eager" and "auto" refuse block widths it does not tile and the first-order
    solvers there; the CPU plans both."""
    sc = solver_config(SOLVER_REGISTRY, name, 16)
    for requested in ("auto", "eager"):
        def resolve():
            return tsel.resolve_backend(requested, config, False, name, sc, 1, H, 6,
                                        platform=platform)
        if refusal is None:
            assert resolve() == "eager"
        else:
            with pytest.raises(ValueError, match=refusal):
                resolve()


def handler_for(kind, act="tanh", dtype="float32"):
    if kind is None:
        return DynamicsHandler(true_model=lambda s, a: s + 0.1 * a.sum(-1, keepdim=True),
                               device="cpu")
    return DynamicsHandler(configs(kind, act, dtype)[1], device="cpu")


POLICY_GRID = [(kind, act, dtype, name, tm, smooth, disc)
               for kind in KINDS for act, dtype in (("tanh", "float32"), ("relu", "bfloat16"),
                                                    ("swish", "float32"))
               for name in sorted(SOLVER_REGISTRY)
               for tm in ((False, True) if name in TIME_MAJOR else (False,))
               for smooth, disc in ((0.0, 1.0), (0.1, 1.0), (0.0, 0.9))]


def test_every_resolved_backend_constructs(open_regimes, monkeypatch):
    """Each grid point resolves (as on a card, through ``platform="cuda"``) to a backend whose
    explicit policy constructs; with the capacity threshold at 0 the fused family resolves to
    "fused" and then refuses smoothness and discount != 1 with JAX's errors."""
    monkeypatch.setattr(tsel, "FUSED_MIN_BYTES", 10**12)
    real = tsel.choose_backend
    monkeypatch.setattr(tsel, "choose_backend",
                        lambda *a, **k: real(*a, **{**k, "platform": "cuda"}))
    space = BoxSpace.of(-1.0, 1.0, dim=U)
    handlers = {}
    seen = {}
    for fused_threshold in (10**12, 0):
        monkeypatch.setattr(tsel, "FUSED_MIN_BYTES", fused_threshold)
        for kind, act, dtype, name, tm, smooth, disc in POLICY_GRID:
            if (kind, act, dtype) not in handlers:
                handlers[kind, act, dtype] = handler_for(kind, act, dtype)
            handler = handlers[kind, act, dtype]
            kw = dict(solver_name=name, planning_horizon=4, population=16, max_iterations=1,
                      action_smoothness_weight=smooth, discount=disc, device="cpu")
            if "num_elite" in SOLVER_REGISTRY[name][0].__dataclass_fields__:
                kw["num_elite"] = 8
            if name == "CMA-ES":
                kw["diagonal"] = True
            if tm:
                kw["time_major"] = True
            try:
                policy = MPCPolicy(space, t_reward, handler, rollout_backend="auto", **kw)
            except ValueError as e:
                # JAX's policy gates on a resolved "fused", and nothing else
                assert fused_threshold == 0 and (smooth > 0 or disc != 1.0), e
                assert "rollout_backend='auto' selected the fused solver" in str(e)
                continue
            resolved = policy.rollout_backend
            explicit = MPCPolicy(space, t_reward, handler, rollout_backend=resolved, **kw)
            assert explicit.rollout_backend == resolved
            seen[resolved] = seen.get(resolved, 0) + 1
    assert set(seen) == {"eager", "kernel", "fused"}, seen


def test_auto_on_cpu_is_the_eager_policy():
    """A CPU policy asked for auto is an eager policy: the same actions, bit for bit."""
    obs = np.array([0.3, -0.2, 0.1], np.float32)
    kw = dict(solver_name="CEM", planning_horizon=H, population=32, num_elite=4,
              max_iterations=2, seed=5, device="cpu")
    handler = handler_for((False, "mean"))
    auto = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler, rollout_backend="auto",
                     **kw)
    eager = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler, **kw)
    assert auto.rollout_backend == "eager"
    for t in range(3):
        a, b = auto.act(obs, t), eager.act(obs, t)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_switch_solver_resolves_again(monkeypatch, caplog):
    """``switch_solver`` resolves auto for the new solver: on a card CEM runs on "kernel",
    Gradient on "eager", and past the capacity threshold CEM on "fused" (logged as a change of
    sampling law) and PSO on "kernel". The policy acts after each switch (the kernel backends
    run their plain versions on CPU tensors)."""
    real = tsel.choose_backend
    monkeypatch.setattr(tsel, "choose_backend",
                        lambda *a, **k: real(*a, **{**k, "platform": "cuda"}))
    obs = np.array([0.3, -0.2, 0.1], np.float32)
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, handler_for((False, "mean")),
                       rollout_backend="auto", planning_horizon=H, population=16, num_elite=4,
                       max_iterations=1, device="cpu")
    assert policy.rollout_backend == "kernel"
    policy.act(obs)
    policy.switch_solver("Gradient")
    assert policy.rollout_backend == "eager"
    policy.act(obs)
    monkeypatch.setattr(tsel, "FUSED_MIN_BYTES", 0)
    with caplog.at_level(logging.INFO, logger="blackbox_mpc_torch.policies.mpc_policy"):
        policy.switch_solver("CEM", population=16, num_elite=4, max_iterations=1)
    assert policy.rollout_backend == "fused"
    assert "clipped normals" in caplog.text
    assert np.all(np.isfinite(policy.act(obs)[0]))
    policy.switch_solver("PSO", population=16, max_iterations=1)
    assert policy.rollout_backend == "kernel"
    policy.act(obs)
