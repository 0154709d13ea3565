"""The graphed eager evaluator (``rollout/evaluator.py::GraphedEvaluator``) off the card.

A CUDA graph needs the card, so most tests here put a fake in the graph's place: it keeps
static input buffers as the graph does, and its replay runs the captured evaluation again on
them. With it the evaluator's own logic runs on the CPU: where it engages (the gate), when it
captures again (the key), the rollout noise's draws, a capture that fails, and the memory
cap. ``tests/test_torch_cuda_graphs.py`` holds the real graphs to the eager path on the card.
"""
import logging

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.deploy.serving import tree_leaves
from blackbox_mpc_torch.parallel.mesh import PopMesh
from blackbox_mpc_torch.policies import mpc_policy
from blackbox_mpc_torch.rollout import evaluator

S, U, H, ITERS = 4, 2, 5, 3
SOLVER = dict(planning_horizon=H, population=24, num_elite=4, max_iterations=ITERS)
PETS = dict(probabilistic=True, learn_logvar_bounds=True, propagation="ts_inf",
            num_particles=3)


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


def handler(**changes) -> DynamicsHandler:
    config = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8, 8), ensemble_size=2,
                                   **{**PETS, **changes})
    return DynamicsHandler(config, seed=3, device="cpu")


def policy(h=None, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, h or handler(), device="cpu",
                     seed=7, **{**SOLVER, **kwargs})


def episodes(n: int = 2, steps: int = 20):
    g = np.random.default_rng(0)
    return ([g.normal(size=(steps + 1, S)).astype(np.float32) for _ in range(n)],
            [g.uniform(-1, 1, (steps, U)).astype(np.float32) for _ in range(n)])


OBS = np.linspace(-0.5, 0.5, S).astype(np.float32)


class FakeGraph:
    """A graph's part on the CPU: static buffers of the call's shapes, and a replay that
    evaluates them again."""

    bytes = 0

    def __init__(self, evaluate, inputs, pool):
        self.inputs = [None if x is None else torch.empty_like(x) for x in inputs]
        self.evaluate, self.pool = evaluate, object() if pool is None else pool

    def __call__(self, inputs):
        for static, x in zip(self.inputs, inputs):
            if x is not None:
                static.copy_(x)
        return self.evaluate(*self.inputs)


def engage(monkeypatch, graph=FakeGraph, card: int = 1 << 40):
    """The graphed evaluator engages on CPU tensors, with ``graph`` for its graphs, on a card
    of ``card`` bytes where nothing is reserved."""
    monkeypatch.setattr(evaluator, "_on_card", lambda x: True)
    monkeypatch.setattr(evaluator, "_Graph", graph)
    monkeypatch.setattr(evaluator, "_memory", lambda device, release=False: (0, card))


@pytest.fixture
def fake_graphs(monkeypatch):
    engage(monkeypatch)


def counts(graphs) -> tuple:
    return graphs.captures, graphs.replays, graphs.graphs


def test_fake_graphs_replay_every_evaluation_after_the_first(fake_graphs):
    p = policy()
    p.act(OBS)
    p.act(OBS)
    assert counts(p.rollout_graphs) == (1, 2 * ITERS - 1, 1)


def _export(p, tmp_path):
    from blackbox_mpc_torch.deploy import export_policy_artifact

    export_policy_artifact(p, str(tmp_path / "ctrl.bbmpc"), platforms=("cpu",))


def _traced_evaluation(p, tmp_path):
    """``torch.export`` traces a module that calls the policy's graphed evaluator."""
    graphs = p.rollout_graphs

    class Evaluate(torch.nn.Module):
        def forward(self, obs, plans):
            return graphs(obs, plans)

    torch.export.export(Evaluate(), (torch.zeros(1, S), torch.zeros(8, 1, H, U)))


@pytest.mark.parametrize("case", ["cpu", "grad", "remat", "mesh", "export", "tracing"])
def test_the_gate_never_captures(case, monkeypatch, tmp_path):
    """Off the card, with grad enabled, with ``remat``, over a mesh and while
    ``torch.export`` traces, no evaluation captures or replays."""
    if case != "cpu":  # everything but the device would let the graphs engage
        engage(monkeypatch)
    if case in ("remat", "mesh"):
        extra = (dict(remat_rollout=True) if case == "remat"
                 else dict(mesh=PopMesh(None, 1, 0, torch.device("cpu"))))
        p = policy(**extra)
        assert p.rollout_graphs is None  # nothing of the policy's may capture
        action = p.act(OBS)[0]
        assert np.all(np.isfinite(action))
        return
    p = policy()
    graphs = p.rollout_graphs
    if case == "cpu":
        p.act(OBS)
        p.act(OBS)
    elif case == "grad":
        with torch.enable_grad():
            plans = torch.zeros(8, 1, H, U, requires_grad=True)
            graphs(torch.zeros(1, S), plans, torch.randn(H, 8 * 3, S)).sum().backward()
            assert plans.grad is not None
    elif case == "export":
        _export(p, tmp_path)
    else:
        _traced_evaluation(p, tmp_path)
    assert counts(graphs) == (0, 0, 0)


@pytest.mark.parametrize("change, recaptures", [
    ("train", True), ("set_params", True), ("load", True), ("replace", False),
    ("edit", True)])
def test_the_key_changes_where_the_parameters_are_replaced(change, recaptures, fake_graphs,
                                                           tmp_path):
    h = handler()
    if change == "load":
        h.train(*episodes(), epochs=1, batch_size=8)  # a checkpoint holds a replay
    p = policy(h)
    p.act(OBS)
    graphs = p.rollout_graphs
    before = graphs.key()
    if change == "train":
        h.train(*episodes(), epochs=1, batch_size=8)
    elif change == "set_params":
        h.set_params(h.dynamics_params)
    elif change == "replace":  # a DynamicsParams of the same tensors
        h._params = h.dynamics_params.replace(params=h.dynamics_params.params)
    elif change == "edit":  # a weight changed in place: what is derived from it is stale
        tree_leaves(h.dynamics_params)[0].mul_(1.0)
    if change == "load":
        h.save(str(tmp_path / "h"))
        loaded = DynamicsHandler.load(str(tmp_path / "h"), device="cpu")
        after = graphs.key(tree_leaves(loaded.dynamics_params))
    else:
        after = graphs.key()
        p.act(OBS)
        assert counts(graphs) == (2 if recaptures else 1, 2 * ITERS - 2 + (not recaptures), 1)
    assert (after != before) == recaptures


def test_parameters_made_in_inference_mode_are_graphed(fake_graphs):
    """Tensors made under ``torch.inference_mode()`` have no version counter: the key counts
    them as version 0, and a policy over them captures once and replays, with the bits of the
    same policy over ordinary tensors."""
    with torch.inference_mode():
        inferred = handler()
    leaves = tree_leaves(inferred.dynamics_params)
    assert leaves and all(t.is_inference() for t in leaves)
    p = policy(inferred)
    got = [p.act(OBS, t) for t in range(2)]
    graphs = p.rollout_graphs
    assert counts(graphs) == (1, 2 * ITERS - 1, 1)
    assert all(entry[-1] == 0 for entry in graphs.key())
    ordinary = policy()
    want = [ordinary.act(OBS, t) for t in range(2)]
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_noise_draws_and_generator_states_unchanged(fake_graphs, monkeypatch):
    """The graphed path draws the same rollout noise in the same order as the eager one and
    leaves both generators where it does; the actions are the same bits."""
    runs = []
    for graphed in (False, True):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(evaluator, "_graphable", lambda inputs: False)
            drawn = []
            original = mpc_policy.rollout_noise
            m.setattr(mpc_policy, "rollout_noise",
                      lambda *args: drawn.append(original(*args)) or drawn[-1])
            p = policy()
            acts = [p.act(OBS, t) for t in range(3)]
            runs.append((drawn, acts, p._generator.get_state(),
                         p._noise_generator.get_state(), p.rollout_graphs.replays))
    (d0, a0, g0, n0, r0), (d1, a1, g1, n1, r1) = runs
    assert (r0, r1) == (0, 3 * ITERS - 1)
    assert len(d0) == len(d1) == 3 * ITERS
    assert all(torch.equal(x, y) for x, y in zip(d0, d1))
    assert torch.equal(g0, g1) and torch.equal(n0, n1)
    for x, y in zip(a0, a1):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


class FailingGraph(FakeGraph):
    def __init__(self, evaluate, inputs, pool):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.mark.parametrize("graph, card, logged", [
    (FailingGraph, 1 << 40, "stays eager until"),
    (FakeGraph, 4096, "GRAPH_MAX_MEMORY_SHARE")])  # the inputs alone pass 1/16 of 4 kB
def test_an_evaluation_that_cannot_be_graphed_stays_eager(graph, card, logged, monkeypatch,
                                                          caplog):
    """A capture that fails, or graphs that would hold too much of the card, leave the
    evaluations eager with the eager answer, logged once; a key is not tried again until the
    parameters change."""
    engage(monkeypatch, graph, card)
    attempts = []
    original = evaluator.GraphedEvaluator._capture
    monkeypatch.setattr(evaluator.GraphedEvaluator, "_capture",
                        lambda self, *args: attempts.append(1) or original(self, *args))
    h = handler()
    p = policy(h)
    with caplog.at_level(logging.WARNING, logger=evaluator.__name__):
        got = [p.act(OBS, t) for t in range(2)]
        h.set_params(h.dynamics_params)
        got.append(p.act(OBS, 2))
    assert counts(p.rollout_graphs) == (0, 0, 0)
    assert len(attempts) == 2  # once per key: one shape
    assert sum(logged in r.getMessage() for r in caplog.records) == 1
    monkeypatch.setattr(evaluator, "_graphable", lambda inputs: False)
    q = policy(handler())  # the same seeds: the same parameters as h
    want = [q.act(OBS, t) for t in range(3)]
    for x, y in zip(got, want):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


def test_one_graph_per_shape_of_an_icem_solve(fake_graphs):
    from blackbox_mpc_torch.solvers.cem import CEMConfig, iteration_populations

    kwargs = dict(population=64, num_elite=4, max_iterations=4, population_decay=0.5)
    shapes = set(iteration_populations(CEMConfig(planning_horizon=H, **kwargs)))
    p = policy(**kwargs)
    for t in range(3):
        p.act(OBS, t)
    assert len(shapes) == 4
    assert counts(p.rollout_graphs) == (4, 3 * 4 - 4, 4)
