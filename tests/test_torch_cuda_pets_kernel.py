"""K2's ts_inf path on the card: PETS' TS-infinity step (Gaussian head, swish, the noise an
input) against its plain version and the eager evaluator at PETS' shape, and a ``"kernel"``
PETS ``act()`` against an ``"eager"`` one.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_pets_kernel.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models.dynamics import make_learned_dynamics
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.ops.backend_select import choose_backend
from blackbox_mpc_torch.ops.measure import (
    PETS, PETS_HORIZON, PETS_POPULATION, pets_launch, pets_params,
)
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

pytestmark = pytest.mark.cuda

# The PETS cell's limit on the action's widest gap, as a share of the half range
# (port_bench/limits/pets_halfcheetah.ts_inf_closed_loop.json).
ANSWER_LIMIT = 5e-6
MAX_SYNCS = 2  # the observation's copy in and the action's copy out


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain and eager paths in full f32
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def pets(device):
    config = LearnedDynamicsConfig(**PETS)
    return config, pets_params(config, device)


def test_ts_inf_kernel_matches_plain_at_pets_shape(device):
    """10 000 particle rows in member-major blocks of 2000 (padded to whole tiles), H=30: the
    states against the plain version, and the launch is counted once. f32 on both sides; the
    kernel sums each product in another order than cuBLAS, 1e-4 of the states' magnitude."""
    args = pets_launch(rk, device, seed=5)[2]
    before = rk.rollout_states.launches
    out = rk.rollout_states(*args)
    torch.cuda.synchronize()
    assert rk.rollout_states.launches == before + 1
    ref = rk.rollout_states_plain(*args)
    scale = max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= 1e-4 * scale


def test_ts_inf_kernel_evaluator_matches_eager_at_pets_shape(device):
    """The returns of 500 candidates x 20 particles over H=30 with one agent, and of 7
    candidates x 20 particles x 2 agents with a NaN start (the guard), against the eager
    evaluator on the same noise; 1e-5 of the largest return's magnitude (the benchmark's
    rounding tie)."""
    config, dp = pets(device)
    dyn = make_learned_dynamics(config)[1]
    k = config.num_particles
    g = torch.Generator(device=device).manual_seed(6)
    kernel = rk.make_rollout_kernel_evaluator(config, reward, device=device)
    eager = make_trajectory_evaluator(lambda s, a, n=None: dyn(dp, s, a, n), reward,
                                      num_particles=k, device=device)
    for pop, agents in ((PETS_POPULATION, 1), (7, 2)):
        s0 = torch.randn((agents, config.dim_s), generator=g, device=device)
        if agents > 1:
            s0[1, 0] = float("nan")
        acts = torch.rand((pop, agents, PETS_HORIZON, config.dim_u), generator=g,
                          device=device) * 2 - 1
        noise = torch.randn((PETS_HORIZON, pop * k * agents, config.dim_s), generator=g,
                            device=device)
        got, want = kernel(dp, s0, acts, noise), eager(s0, acts, noise)
        if agents > 1:
            assert bool((got[:, 1] == -1e6).all())
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_ts_inf_tanh_kernel_matches_eager(device):
    """A ts_inf net of other widths and tanh layers (the same instantiation, another runtime
    branch of its activation), fixed log-variance bounds, 240 particle rows whose member
    blocks of 48 pad to whole tiles: the returns against the eager evaluator's."""
    config = LearnedDynamicsConfig(dim_s=5, dim_u=2, hidden=(64, 48, 100), ensemble_size=5,
                                   probabilistic=True, propagation="ts_inf", num_particles=4)
    init, dyn = make_learned_dynamics(config)
    dp = init(torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator(device=device).manual_seed(7)
    s0 = torch.randn((2, 5), generator=g, device=device)
    acts = torch.rand((30, 2, 6, 2), generator=g, device=device) * 4 - 2
    noise = torch.randn((6, 240, 5), generator=g, device=device)
    got = rk.make_rollout_kernel_evaluator(config, reward, discount=0.9, device=device)(
        dp, s0, acts, noise)
    want = make_trajectory_evaluator(lambda s, a, n=None: dyn(dp, s, a, n), reward,
                                     discount=0.9, num_particles=4, device=device)(
        s0, acts, noise)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ts_inf_kernel_runs_an_ant_sized_net(device):
    """PETS' net at Ant's sizes (S=27, U=8: a 35-wide input and a 54-wide head on 4 x 200
    swish), which ``"auto"`` sends to K2: the launch fits the card's shared memory and its
    returns match the eager evaluator's, 1e-5 of the largest return's magnitude."""
    config = LearnedDynamicsConfig(**{**PETS, "dim_s": 27, "dim_u": 8})
    assert choose_backend(config, 100, 1, platform="cuda", horizon=PETS_HORIZON,
                          dim_u=config.dim_u, solver_name="CEM") == "kernel"
    dp = pets_params(config, device)
    dyn = make_learned_dynamics(config)[1]
    k = config.num_particles
    g = torch.Generator(device=device).manual_seed(8)
    s0 = torch.randn((1, config.dim_s), generator=g, device=device)
    acts = torch.rand((100, 1, PETS_HORIZON, config.dim_u), generator=g, device=device) * 2 - 1
    noise = torch.randn((PETS_HORIZON, 100 * k, config.dim_s), generator=g, device=device)
    got = rk.make_rollout_kernel_evaluator(config, reward, device=device)(dp, s0, acts, noise)
    want = make_trajectory_evaluator(lambda s, a, n=None: dyn(dp, s, a, n), reward,
                                     num_particles=k, device=device)(s0, acts, noise)
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


def policy_on(device, backend):
    config, dp = pets(device)
    handler = DynamicsHandler(config, seed=0, device=device)
    handler.set_params(dp)
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.dim_u), reward, handler, seed=11,
                     planning_horizon=PETS_HORIZON, population=PETS_POPULATION, num_elite=50,
                     max_iterations=5, alpha=0.1, rollout_backend=backend, device=device)


def test_kernel_pets_act_matches_eager_waits_twice_and_launches_five_times(device):
    """The PETS cell's controller on "kernel" and on "eager" from the same seed: three
    ``act()``s give the same actions within the cell's ``answer`` limit; a kernel ``act()``
    waits for the card at most twice and launches K2 once per CEM iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = np.random.default_rng(8)
    observations = g.normal(0, 1, (3, PETS["dim_s"])).astype(np.float32)
    actions = {}
    for backend in ("kernel", "eager"):
        policy = policy_on(device, backend)
        assert policy.rollout_backend == backend
        actions[backend] = np.stack([policy.act(obs)[0] for obs in observations])
    assert np.abs(actions["kernel"] - actions["eager"]).max() <= ANSWER_LIMIT

    policy = policy_on(device, "auto")
    assert policy.rollout_backend == "kernel"
    policy.act(observations[0])  # warm-up: builds and loads the library
    before = rk.rollout_states.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        action = policy.act(observations[1])[0]
    assert rk.rollout_states.launches == before + 5
    syncs = sum(1 for e in prof.events()
                if e.name == "cudaStreamSynchronize" and e.device_type == DeviceType.CPU)
    assert syncs <= MAX_SYNCS
    assert np.all(np.isfinite(action)) and np.all(np.abs(action) <= 1.0)


def test_tensor_core_launches_count_the_ts_inf_path_alone(device):
    """``rollout_states.tensor_core_launches`` counts the launches that ran ts_inf's 3xTF32
    layers: 5 over a PETS ``act()`` (one per CEM iteration), none over a mean-propagation
    launch at the flagship's shape (1000 rows, H=50, 5 x 3 x 500 tanh, float32)."""
    g = np.random.default_rng(9)
    policy = policy_on(device, "kernel")
    policy.act(g.normal(0, 1, PETS["dim_s"]).astype(np.float32))  # warm-up
    launches, tensor = rk.rollout_states.launches, rk.rollout_states.tensor_core_launches
    policy.act(g.normal(0, 1, PETS["dim_s"]).astype(np.float32))
    assert rk.rollout_states.launches == launches + 5
    assert rk.rollout_states.tensor_core_launches == tensor + 5

    flagship = LearnedDynamicsConfig(dim_s=17, dim_u=6, hidden=(500, 500, 500), ensemble_size=5)
    dp = make_learned_dynamics(flagship)[0](torch.Generator().manual_seed(1)).to(device)
    evaluate = rk.make_rollout_kernel_evaluator(flagship, reward, device=device)
    gen = torch.Generator(device=device).manual_seed(10)
    s0 = torch.randn((1, 17), generator=gen, device=device)
    acts = torch.rand((1000, 1, 50, 6), generator=gen, device=device) * 2 - 1
    launches, tensor = rk.rollout_states.launches, rk.rollout_states.tensor_core_launches
    assert bool(torch.isfinite(evaluate(dp, s0, acts)).all())
    assert rk.rollout_states.launches == launches + 1
    assert rk.rollout_states.tensor_core_launches == tensor
