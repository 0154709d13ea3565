"""The single-card entry points on the card: a ``.bbmpc`` artifact exported on ``cuda``
continues bit for bit in a ``ServingPolicy`` there, a device-resident episode waits for the
card once (its readback), and ``rollout_backend="auto"`` gives the bits of the backend it
resolves to (``"kernel"``, and ``"fused"`` past the capacity threshold).

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \\
        tests/test_torch_cuda_entry_points.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.deploy import ServingPolicy, export_policy_artifact
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.ops import backend_select
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.ops.fused_cem import make_fused_cem
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY, CEMConfig, make_cem
from blackbox_mpc_torch.utils import profiling
from blackbox_mpc_torch.workflows import evaluate_solver_on_model

pytestmark = pytest.mark.cuda

NET = dict(dim_s=6, dim_u=2, hidden=(64, 64), ensemble_size=5)
SOLVER = dict(planning_horizon=10, population=96, num_elite=8, max_iterations=3)
OBS = np.linspace(-0.5, 0.5, 6).astype(np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def policy_on(device, backend="eager", handler=None, solver_name="CEM", **kw):
    handler = handler or DynamicsHandler(LearnedDynamicsConfig(**NET), seed=0, device=device)
    fields = SOLVER_REGISTRY[solver_name][0].__dataclass_fields__
    kw = {k: v for k, v in {**SOLVER, **kw}.items() if k in fields}
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), reward, handler, rollout_backend=backend,
                     solver_name=solver_name, seed=1, device=device, **kw)


def same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("solver", ["CEM", "PI2", "CMA-ES"])
def test_artifact_continues_bitwise_on_cuda(device, tmp_path, solver):
    kw = {"diagonal": True} if solver == "CMA-ES" else {}
    policy = policy_on(device, solver_name=solver, **kw)
    policy.act(OBS)
    path = str(tmp_path / "pol.bbmpc")
    meta = export_policy_artifact(policy, path, platforms=("cuda", "cpu"))
    assert meta["rng_impl"] == "philox4x32-10" and meta["platforms"] == ["cuda", "cpu"]
    srv = ServingPolicy.load(path)
    assert srv.device.type == "cuda"
    for t, explore in ((1, False), (2, True), (3, False)):
        same(policy.act(OBS, t, exploration_noise=explore),
             srv.act(OBS, t, exploration_noise=explore))
    policy.reset()
    srv.reset()
    same(policy.act(OBS), srv.act(OBS))
    # the CPU program of the same artifact runs there, on a fresh stream
    cpu = ServingPolicy.load(path, device="cpu", seed=3)
    assert np.all(np.isfinite(cpu.act(OBS)[0]))


def test_device_episode_waits_once(device, tmp_path):
    """Eager CEM over the analytic pendulum and fused CEM over a learned model: one
    ``cudaStreamSynchronize`` for a whole episode with its readback; K4 and K6 once per
    iteration of every fused solve."""
    from torch.autograd import DeviceType

    handler = DynamicsHandler(LearnedDynamicsConfig(**NET), seed=0, device=device)
    dp = handler.dynamics_params
    config = CEMConfig(**SOLVER)
    drives = [
        (make_cem(CEMConfig(**SOLVER), Bounds.of(-2.0, 2.0, dim=1),
                  make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device=device)),
         pendulum_dynamics, pendulum_reward, np.array([[-1.0, 0.0, 0.0]], np.float32), 0),
        (make_fused_cem(config, Bounds.of(-1.0, 1.0, dim=2), handler.config, dp, reward),
         lambda s, a: handler.mean_dynamics_fn(dp, s, a), reward, OBS[None], SOLVER[
             "max_iterations"]),
    ]
    for solver, dynamics, rew, obs, per_step in drives:
        initial = torch.as_tensor(obs, device=device)  # its copy in is not the episode's

        def episode():
            rewards, final, _ = evaluate_solver_on_model(
                solver, dynamics, rew, initial, 6, torch.Generator(device=device).manual_seed(0))
            return rewards.cpu().numpy()

        episode()  # warm-up
        counts = (fc.fused_rollout.launches, fc.elite_moments.launches)
        with profiling.trace(str(tmp_path)) as prof:
            out = episode()
        assert np.all(np.isfinite(out))
        syncs = sum(1 for e in prof.events() if e.name == "cudaStreamSynchronize"
                    and e.device_type == DeviceType.CPU)
        assert syncs <= 1
        assert (fc.fused_rollout.launches - counts[0],
                fc.elite_moments.launches - counts[1]) == (6 * per_step, 6 * per_step)


def test_auto_resolves_and_matches_explicit_bits(device, monkeypatch):
    handler = DynamicsHandler(LearnedDynamicsConfig(**NET), seed=0, device=device)
    auto = policy_on(device, "auto", handler)
    assert auto.rollout_backend == "kernel"
    launches = rk.rollout_states.launches
    got = [auto.act(OBS, t)[0] for t in range(2)]
    assert rk.rollout_states.launches - launches == 2 * SOLVER["max_iterations"]
    want = [policy_on(device, "kernel", handler).act(OBS, t)[0] for t in range(1)]
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.setattr(backend_select, "FUSED_MIN_BYTES", 1)
    auto = policy_on(device, "auto", handler)
    assert auto.rollout_backend == "fused"
    explicit = policy_on(device, "fused", handler)
    for t in range(2):
        np.testing.assert_array_equal(auto.act(OBS, t)[0], explicit.act(OBS, t)[0])
    # a true model, and Gradient, stay eager on the card
    true = DynamicsHandler(true_model=lambda s, a: s, device=device)
    assert policy_on(device, "auto", true).rollout_backend == "eager"
    assert policy_on(device, "auto", handler,
                     solver_name="Gradient").rollout_backend == "eager"
