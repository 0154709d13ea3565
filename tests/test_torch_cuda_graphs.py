"""The graphed eager evaluator on the card: an ``act()`` whose evaluations replay CUDA graphs
against the same ``act()`` on the eager loop, bit for bit (actions, predictions, both
generators' states), for ``ts_inf``, ``mm``, ``mean`` and the penalized path; a capture again
after ``train()``; one graph per shape of an iCEM solve; ``plan()`` read-only; the graphs
bounded over train/act cycles; a capture that fails; the spans of a replayed ``act()``.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_graphs.py -q
"""
import contextlib

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.rollout import evaluator

pytestmark = pytest.mark.cuda

S, U, H, AGENTS, ACTS = 6, 2, 10, 2, 4
NET = dict(dim_s=S, dim_u=U, hidden=(64, 64), ensemble_size=5, probabilistic=True,
           learn_logvar_bounds=True)
CONFIGS = {
    "ts_inf": dict(propagation="ts_inf", num_particles=4),
    "mm": dict(propagation="mm", num_particles=4),
    "mean": dict(propagation="mean"),
    "mean + penalty": dict(propagation="mean", plan_uncertainty_penalty=1.0),
}
SOLVER = dict(planning_horizon=H, population=64, num_elite=8, max_iterations=3,
              warm_start=True)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * (a * a).sum(-1)


def handler_on(device, label: str = "ts_inf") -> DynamicsHandler:
    return DynamicsHandler(LearnedDynamicsConfig(**NET, **CONFIGS[label]), seed=0,
                           device=device)


def policy_on(handler, seed: int = 5, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, handler, num_agents=AGENTS,
                     seed=seed, device=handler.device, **{**SOLVER, **kwargs})


def episodes(n: int = 2, steps: int = 40):
    g = np.random.default_rng(1)
    return ([g.normal(size=(steps + 1, S)).astype(np.float32) for _ in range(n)],
            [g.uniform(-1, 1, (steps, U)).astype(np.float32) for _ in range(n)])


def observations(n: int = ACTS) -> list:
    g = np.random.default_rng(2)
    return [g.normal(size=(AGENTS, S)).astype(np.float32) for _ in range(n)]


def acts(policy, obs_list, t0: int = 0) -> list:
    """Each ``act()``'s action, prediction and reward, and both generators' states after it."""
    out = []
    for t, obs in enumerate(obs_list, t0):
        out.append((*policy.act(obs, t, exploration_noise=t % 2 == 1),
                    policy._generator.get_state(), policy._noise_generator.get_state()))
    return out


def same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if torch.is_tensor(x):
                assert torch.equal(x, y)
            else:
                assert np.array_equal(x, y)


@contextlib.contextmanager
def eager(monkeypatch):
    """Every evaluation inside runs the eager loop."""
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        yield


@pytest.mark.parametrize("label", list(CONFIGS))
def test_graphed_act_equals_eager_bit_for_bit(device, label, monkeypatch):
    h = handler_on(device, label)
    graphed = policy_on(h)
    got = acts(graphed, observations())
    with eager(monkeypatch):
        want = acts(policy_on(h), observations())
    same_bits(got, want)
    graphs = graphed.rollout_graphs
    assert (graphs.captures, graphs.replays, graphs.graphs) == (1, ACTS * 3 - 1, 1)


def test_capture_again_after_train_gives_the_new_parameters_answer(device, monkeypatch):
    h = handler_on(device)
    graphed, reference, obs = policy_on(h), policy_on(h), observations(2 * ACTS)
    got = acts(graphed, obs[:ACTS])
    with eager(monkeypatch):
        want = acts(reference, obs[:ACTS])
    h.train(*episodes(), epochs=2, batch_size=16)
    got += acts(graphed, obs[ACTS:], ACTS)
    with eager(monkeypatch):
        want += acts(reference, obs[ACTS:], ACTS)
    assert graphed.rollout_graphs.captures == 2
    same_bits(got, want)


def test_one_graph_per_shape_of_an_icem_solve(device, monkeypatch):
    from blackbox_mpc_torch.solvers.cem import CEMConfig, iteration_populations

    decay = dict(population=256, max_iterations=4, population_decay=0.5)
    shapes = set(iteration_populations(CEMConfig(**{**SOLVER, **decay})))
    h = handler_on(device)
    graphed = policy_on(h, **decay)
    got = acts(graphed, observations())
    assert graphed.rollout_graphs.graphs == len(shapes) == 4
    assert graphed.rollout_graphs.captures == 4
    with eager(monkeypatch):
        want = acts(policy_on(h, **decay), observations())
    same_bits(got, want)


def test_plan_stays_read_only(device, monkeypatch):
    h = handler_on(device)
    graphed = policy_on(h)
    obs = observations(2)
    acts(graphed, obs[:1])
    before = (graphed._solver_state.mean.clone(), graphed._generator.get_state(),
              graphed._noise_generator.get_state())
    plan, expected = graphed.plan(obs[1], 1)
    after = (graphed._solver_state.mean, graphed._generator.get_state(),
             graphed._noise_generator.get_state())
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert graphed.rollout_graphs.replays > 0
    with eager(monkeypatch):
        reference = policy_on(h)
        acts(reference, obs[:1])
        want = reference.plan(obs[1], 1)
    assert np.array_equal(plan, want[0]) and np.array_equal(expected, want[1])


def test_graphs_stay_bounded_over_train_act_cycles(device):
    h = handler_on(device)
    graphed = policy_on(h)
    observations_, actions = episodes()
    reserved = []
    for cycle in range(20):
        h.train(observations_, actions, epochs=1, batch_size=16)
        graphed.act(observations(1)[0], cycle)
        assert graphed.rollout_graphs.graphs == 1  # one candidate shape
        reserved.append(torch.cuda.memory_reserved(device))
    assert graphed.rollout_graphs.captures == 20
    assert max(reserved[2:]) <= 1.5 * max(reserved[:2])


def test_a_capture_that_fails_stays_eager(device, monkeypatch):
    """A reward that waits for the card cannot be captured: the evaluations stay eager, with
    the eager answer, and the stream the caller had is current again."""

    def syncing_reward(s, a, ns):
        r = reward(s, a, ns)
        if bool(torch.isnan(r).any()):  # a host sync
            r = torch.nan_to_num(r)
        return r

    h = handler_on(device)
    graphed = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), syncing_reward, h, num_agents=AGENTS,
                        seed=5, device=device, **SOLVER)
    stream = torch.cuda.current_stream(device)
    got = acts(graphed, observations())
    assert torch.cuda.current_stream(device) == stream
    assert (graphed.rollout_graphs.captures, graphed.rollout_graphs.replays) == (0, 0)
    with eager(monkeypatch):
        reference = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), syncing_reward, h,
                              num_agents=AGENTS, seed=5, device=device, **SOLVER)
        want = acts(reference, observations())
    same_bits(got, want)


def test_a_replayed_act_opens_no_model_step(device, tmp_path):
    """Traced, a replayed evaluation is ``evaluator.evaluate`` > ``evaluator.replay`` with no
    ``models.step``, and the graph's kernels are the trace's device operations."""
    from torch.autograd import DeviceType

    from blackbox_mpc_torch.utils import profiling

    graphed = policy_on(handler_on(device))
    obs = observations(2)
    graphed.act(obs[0])
    with profiling.trace(str(tmp_path)) as prof:
        graphed.act(obs[1], 1)
    events = prof.profiler.kineto_results.events()
    names = [e.name() for e in events if e.is_user_annotation()
             and e.device_type() == DeviceType.CPU]
    assert names.count("evaluator.evaluate") == names.count("evaluator.replay") == 3
    assert "models.step" not in names and "evaluator.capture" not in names
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    assert len(kernels) > 3 * H * 10  # the replays' kernels are traced one by one
