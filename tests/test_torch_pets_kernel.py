"""K2's ts_inf path on the CPU: the plain version behind the rollout kernel's wrapper (what
runs on CPU tensors) with PETS' Gaussian head, swish, learned log-variance bounds and the
noise as an input, against the port's eager ts_inf evaluator on the same noise; the policy's
"kernel" PETS ``act()`` against its "eager" one; and ``"auto"``'s gate for ts_inf. The CUDA
kernel itself is held against the plain version on the card in
``test_torch_cuda_pets_kernel.py``."""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
from blackbox_mpc_torch.models.normalizer import NormalizerStats
from blackbox_mpc_torch.ops import _kernel_common as kc
from blackbox_mpc_torch.ops import backend_select as tsel
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.parallel import PopMesh
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY

torch.set_num_threads(1)

# A 24 -> 16 x 2 -> 12 net: S = 6 states (a head of mean and log-variance, 12 wide) and U = 18.
S, U, E, K, H = 6, 18, 5, 4, 5
# The plain version and the eager evaluator run the same float32 operations on the same rows;
# only the grouping of the rows into matrix products differs (the plain version's member
# blocks carry padding rows), which may change a product's blocking.
TOL = dict(rtol=1e-6, atol=1e-6)


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def pets_config(**changes):
    fields = dict(dim_s=S, dim_u=U, hidden=(16, 16), activation="swish", ensemble_size=E,
                  probabilistic=True, learn_logvar_bounds=True, propagation="ts_inf",
                  num_particles=K)
    fields.update(changes)
    return LearnedDynamicsConfig(**fields)


def params(config, seed=0):
    """Weights at a gain that makes the net matter, a normalizer off the identity, and learned
    bounds moved off their start (a swapped lower and upper bound would show)."""
    g = torch.Generator().manual_seed(seed)
    dp = make_learned_dynamics(config)[0](g)
    net = dp.params["net"] if isinstance(dp.params, dict) else dp.params
    net = [{"w": 1.5 * layer["w"], "b": 0.1 * torch.randn(layer["b"].shape, generator=g)}
           for layer in net]
    s, u = config.dim_s, config.dim_u
    stats = NormalizerStats(torch.randn(s, generator=g), 0.5 + torch.rand(s, generator=g),
                            0.3 * torch.randn(u, generator=g), 0.5 + torch.rand(u, generator=g),
                            0.05 * torch.randn(s, generator=g),
                            0.05 + 0.2 * torch.rand(s, generator=g))
    if isinstance(dp.params, dict):
        bounds = {"lv_min": -8.0 + torch.rand(s, generator=g),
                  "lv_max": -1.0 + torch.rand(s, generator=g)}
        return dp.replace(params={"net": net, **bounds}, stats=stats)
    return dp.replace(params=net, stats=stats)


def evaluators(config, dp, **kw):
    dyn = make_learned_dynamics(config)[1]
    kernel = rk.make_rollout_kernel_evaluator(config, reward, device="cpu", **kw)
    k = config.num_particles if config.propagation == "ts_inf" else 1
    eager = make_trajectory_evaluator(lambda s, a, n=None: dyn(dp, s, a, n), reward,
                                      num_particles=k, device="cpu", **kw)
    return (lambda s0, acts, noise=None: kernel(dp, s0, acts, noise)), eager


@pytest.mark.parametrize("pop,agents,discount,fixed_bounds", [
    (5, 2, 1.0, False),   # 40 rows: 8 a member, each block padded to a whole tile
    (15, 2, 0.95, False),  # 120 rows: 24 a member
    (10, 1, 1.0, True),   # the fixed bounds (-10, 0.5)
])
def test_plain_ts_inf_matches_eager_evaluator(pop, agents, discount, fixed_bounds,
                                              monkeypatch):
    config = pets_config(learn_logvar_bounds=not fixed_bounds)
    dp = params(config)
    g = torch.Generator().manual_seed(1)
    s0 = torch.randn((agents, S), generator=g)
    acts = 2 * torch.rand((pop, agents, H, U), generator=g) - 1
    noise = torch.randn((H, pop * K * agents, S), generator=g)
    kernel, eager = evaluators(config, dp, discount=discount)
    calls = []
    real = rk.rollout_states

    def spy(*args):
        calls.append(args)
        return real(*args)

    rows = pop * K * agents
    monkeypatch.setattr(rk, "rollout_states", spy)
    got = kernel(s0, acts, noise)
    torch.testing.assert_close(got, eager(s0, acts, noise), **TOL)
    # whole tiles of one member each, member-major, and the noise laid out as the rows
    (_, _, actions, _, tile_member, laid), = calls
    block = -(-(rows // E) // rk.TILE_TS_INF) * rk.TILE_TS_INF
    assert actions.shape[1] == laid.shape[1] == E * block
    np.testing.assert_array_equal(tile_member.numpy(),
                                  np.repeat(np.arange(E), block // rk.TILE_TS_INF))


def test_plain_ts_inf_nan_guard_after_the_particle_mean():
    """A NaN start gives its agent -1e6 on every candidate, as the eager evaluator does."""
    config = pets_config()
    dp = params(config)
    g = torch.Generator().manual_seed(2)
    s0 = torch.randn((2, S), generator=g)
    s0[1, 0] = float("nan")
    acts = 2 * torch.rand((5, 2, H, U), generator=g) - 1
    noise = torch.randn((H, 5 * K * 2, S), generator=g)
    kernel, eager = evaluators(config, dp)
    got = kernel(s0, acts, noise)
    assert bool((got[:, 1] == -1e6).all()) and bool(torch.isfinite(got[:, 0]).all())
    torch.testing.assert_close(got, eager(s0, acts, noise), **TOL)


def test_ts_inf_evaluator_checks_its_noise():
    config = pets_config()
    dp = params(config)
    kernel, _ = evaluators(config, dp)
    s0, acts = torch.zeros(1, S), torch.zeros(5, 1, H, U)
    with pytest.raises(ValueError, match="noise"):
        kernel(s0, acts)
    with pytest.raises(ValueError, match="noise must be"):
        kernel(s0, acts, torch.zeros(H, 5, S))
    with pytest.raises(ValueError, match="divisible"):
        kernel(s0, torch.zeros(3, 1, H, U), torch.zeros(H, 3 * K, S))
    mean = pets_config(probabilistic=False, propagation="mean", learn_logvar_bounds=False,
                       activation="tanh")
    mean_kernel, _ = evaluators(mean, params(mean))
    with pytest.raises(ValueError, match="noise"):
        mean_kernel(s0, acts, torch.zeros(H, 5, S))
    with pytest.raises(ValueError, match="float32"):
        rk.make_rollout_kernel_evaluator(pets_config(compute_dtype=torch.bfloat16), reward,
                                         device="cpu")


def test_operands_carry_the_bounds_and_the_head():
    """The head is 2S wide in the kernel's widths; the bounds are the learned ones, or the
    fixed ones; an in-place change of a bound packs the operands again."""
    config = pets_config()
    dp = params(config)
    ops = rk.make_operands(dp, config)
    assert ops.widths == (24, 16, 16, 12)
    torch.testing.assert_close(ops.lv_bounds, torch.stack([dp.params["lv_min"],
                                                           dp.params["lv_max"]]), rtol=0, atol=0)
    fixed = pets_config(learn_logvar_bounds=False)
    fixed_ops = rk.make_operands(params(fixed), fixed)
    torch.testing.assert_close(fixed_ops.lv_bounds,
                               torch.tensor([[-10.0] * S, [0.5] * S]), rtol=0, atol=0)
    operands = rk.operand_cache(config)
    first = operands(dp)
    assert operands(dp) is first
    dp.params["lv_max"].add_(0.1)
    assert operands(dp) is not first


def test_swish_mean_net_stays_eager_and_its_plain_step_matches_eager():
    """A deterministic swish net: swish is compiled into ts_inf's kernel alone, so the kernel
    evaluator refuses it and "auto" keeps it eager; the plain step (``build_step_fn``, which
    ts_inf's twin runs) computes it as the eager dynamics do."""
    config = pets_config(probabilistic=False, propagation="mean", learn_logvar_bounds=False,
                         dim_s=4, dim_u=2)
    dp = params(config)
    with pytest.raises(ValueError, match="activation"):
        rk.make_rollout_kernel_evaluator(config, reward, device="cpu")
    assert tsel.choose_backend(config, 11, 3, platform="cuda", horizon=H, dim_u=2,
                               solver_name="CEM") == "eager"
    ops = rk.make_operands(dp, config)
    g = torch.Generator().manual_seed(3)
    s, a = torch.randn((7, 4), generator=g), 4 * torch.rand((7, 2), generator=g) - 2
    got = kc.build_step_fn(config, ops.stats, ops.weights)(s, a)
    torch.testing.assert_close(got, make_learned_dynamics(config)[1](dp, s, a), **TOL)


def test_kernel_pets_act_matches_eager_act_on_cpu():
    """The policy on "kernel" (the plain version on CPU tensors) draws the eager path's noise
    from the same generator states: three ``act()``s and the carried plan agree with "eager"
    to float32 rounding."""
    config = pets_config()
    handler = DynamicsHandler(config, device="cpu")
    handler.set_params(params(config))
    kw = dict(num_agents=2, planning_horizon=H, population=10, num_elite=3, max_iterations=2,
              seed=4, device="cpu")
    policies = {b: MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, handler,
                             rollout_backend=b, **kw) for b in ("kernel", "eager")}
    obs = np.random.default_rng(5).normal(0, 1, (3, 2, S)).astype(np.float32)
    for t in range(3):
        a, b = (policies[name].act(obs[t], t) for name in ("kernel", "eager"))
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(policies["kernel"]._solver_state.mean,
                               policies["eager"]._solver_state.mean, rtol=1e-5, atol=1e-6)


def test_choose_backend_sends_pets_to_the_kernel():
    """PETS' shape (500 candidates x 20 particles, 4 x 200, H=30) goes to "kernel"; mm, the
    uncertainty penalty, a mesh, bfloat16, time_major, a first-order solver, particle rows
    beyond ``KERNEL_MAX_ROWS`` and layers wider than ``KERNEL_TS_INF_MAX_WIDTH`` (the widest
    measured) stay "eager"."""
    pets = pets_config(dim_s=18, dim_u=6, hidden=(200,) * 4, num_particles=20)
    kw = dict(platform="cuda", horizon=30, dim_u=6, solver_name="CEM")
    assert tsel.choose_backend(pets, 500, 1, **kw) == "kernel"
    rows_cap = tsel.KERNEL_MAX_ROWS // 20
    assert tsel.choose_backend(pets, rows_cap, 1, **kw) == "kernel"
    assert tsel.choose_backend(pets, rows_cap + 5, 1, **kw) == "eager"
    assert tsel.KERNEL_TS_INF_MAX_WIDTH == 200
    wide = pets_config(dim_s=18, dim_u=6, hidden=(256,) * 4, num_particles=20)
    assert tsel.choose_backend(wide, 500, 1, **kw) == "eager"
    mm = pets_config(dim_s=18, dim_u=6, hidden=(200,) * 4, propagation="mm", num_particles=20)
    penalty = pets_config(dim_s=18, dim_u=6, hidden=(200,) * 4, propagation="mean",
                          num_particles=1, plan_uncertainty_penalty=1.0)
    deterministic_penalty = LearnedDynamicsConfig(dim_s=18, dim_u=6, hidden=(200,) * 4,
                                                  ensemble_size=5, plan_uncertainty_penalty=1.0)
    bf16 = pets_config(dim_s=18, dim_u=6, hidden=(200,) * 4, num_particles=20,
                       compute_dtype=torch.bfloat16)
    for config in (mm, penalty, deterministic_penalty, bf16):
        assert tsel.choose_backend(config, 500, 1, **kw) == "eager"
    two = PopMesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    assert tsel.choose_backend(pets, 500, 1, mesh=two, **kw) == "eager"
    assert tsel.choose_backend(pets, 500, 1, solver_config=SOLVER_REGISTRY["CEM"][0](
        time_major=True), **kw) == "eager"
    assert tsel.choose_backend(pets, 500, 1, **dict(kw, solver_name="CEM-GD")) == "eager"
    # never "fused" (its kernels are deterministic), past the capacity threshold too, where
    # a deterministic tanh net goes "fused"
    huge = tsel.FUSED_MIN_BYTES // (30 * 6 * 4) + 1
    assert tsel.choose_backend(pets, huge, 1, **kw) == "eager"
    tanh = LearnedDynamicsConfig(dim_s=18, dim_u=6, hidden=(200,) * 4, ensemble_size=5)
    assert tsel.choose_backend(tanh, huge, 1, **kw) == "fused"


def test_auto_pets_policy_resolves_to_the_kernel_on_a_card(monkeypatch):
    """As on a card (``platform="cuda"``), "auto" gives a ts_inf policy the kernel; on the CPU
    it stays eager."""
    real = tsel.choose_backend
    config = pets_config()
    handler = DynamicsHandler(config, device="cpu")
    kw = dict(planning_horizon=H, population=10, num_elite=3, max_iterations=1, device="cpu")
    space = BoxSpace.of(-1.0, 1.0, dim=U)
    assert MPCPolicy(space, reward, handler, rollout_backend="auto", **kw).rollout_backend \
        == "eager"
    monkeypatch.setattr(tsel, "choose_backend",
                        lambda *a, **k: real(*a, **{**k, "platform": "cuda"}))
    policy = MPCPolicy(space, reward, handler, rollout_backend="auto", **kw)
    assert policy.rollout_backend == "kernel"
    assert np.all(np.isfinite(policy.act(np.zeros(S, np.float32))[0]))
