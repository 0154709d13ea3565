"""The program's spans (``utils/profiling.py::span``): the tree one ``act()`` records under
``profiling.trace`` on the eager and the kernel backend (on the CPU the kernel's wrapper takes
its plain version), stochastic dynamics, training, the kernels' build; and what a span costs
where no profiler runs, or while ``torch.export`` traces."""
import glob

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.ops import _build
from blackbox_mpc_torch.utils import profiling

S, U, H, ITERS = 4, 2, 5, 3
SOLVER = dict(planning_horizon=H, population=24, num_elite=4, max_iterations=ITERS)
LAYERS = ("policy.", "solver.", "evaluator.", "models.", "kernels.", "learning.")


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


def span_tree(prof) -> list:
    """The program's spans in ``prof``'s trace as ``[(name, [children...]), ...]`` in time
    order, each span's parent the innermost span around it."""
    events = prof.profiler.kineto_results.events()
    spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in events
                    if e.is_user_annotation() and e.name().startswith(LAYERS)),
                   key=lambda x: (x[0], -x[1]))
    roots, stack = [], []
    for start, end, name in spans:
        while stack and stack[-1][0] <= start:  # the open span ended before this one began
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((end, node))
    return roots


def names(nodes) -> list:
    return [name for name, _ in nodes]


def handler(**config) -> DynamicsHandler:
    torch.manual_seed(0)
    return DynamicsHandler(LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8, 8),
                                                 ensemble_size=2, **config), device="cpu")


def traced_act(tmp_path, policy):
    obs = np.linspace(-0.5, 0.5, S).astype(np.float32)
    policy.act(obs)  # first use outside the window
    with profiling.trace(str(tmp_path)) as prof:
        policy.act(obs)
    assert len(glob.glob(str(tmp_path / "*.json"))) == 1
    return span_tree(prof)


@pytest.mark.parametrize("backend", ["eager", "kernel"])
def test_act_records_the_span_tree(tmp_path, backend):
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, handler(),
                       rollout_backend=backend, device="cpu", **SOLVER)
    (act,) = traced_act(tmp_path, policy)
    assert act[0] == "policy.act"
    assert names(act[1]) == ["policy.obs_in", "solver.solve", "policy.lookahead",
                             "policy.wait"]
    iterations = act[1][1][1]
    assert names(iterations) == ["solver.iteration"] * ITERS
    for _, parts in iterations:
        assert names(parts) == ["solver.sample", "evaluator.evaluate", "solver.update"]
        evaluation = parts[1][1]
        if backend == "eager":
            assert names(evaluation) == ["models.step"] * H
        else:
            assert names(evaluation) == ["kernels.K2"]


def test_stochastic_act_steps_the_model_inside_the_evaluation(tmp_path):
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward,
                       handler(probabilistic=True, propagation="ts_inf", num_particles=3),
                       rollout_backend="eager", device="cpu", **SOLVER)
    (act,) = traced_act(tmp_path, policy)
    for _, parts in act[1][1][1]:
        assert names(parts) == ["solver.sample", "evaluator.evaluate", "solver.update"]
        assert names(parts[1][1]) == ["models.step"] * H


def test_random_search_samples_evaluates_and_picks(tmp_path):
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, handler(),
                       solver_name="RandomSearch", planning_horizon=H, population=32,
                       rollout_backend="kernel", device="cpu")
    (act,) = traced_act(tmp_path, policy)
    (solve,) = [node for node in act[1] if node[0] == "solver.solve"]
    assert names(solve[1]) == ["solver.sample", "evaluator.evaluate", "solver.update"]
    assert names(solve[1][1][1]) == ["kernels.K2"]


def test_train_records_batches_and_steps(tmp_path):
    h = handler()
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2, 21, S)).astype(np.float32)
    acts = rng.normal(size=(2, 20, U)).astype(np.float32)
    h.train(obs, acts, epochs=1, batch_size=8)
    with profiling.trace(str(tmp_path)) as prof:
        h.train(epochs=1, batch_size=8)
    tree = span_tree(prof)
    steps = names(tree).count("learning.step")
    assert steps > 0
    # One batch before each step, and one last look that finds the epoch's end.
    assert names(tree) == ["learning.batch", "learning.step"] * steps + ["learning.batch"]


def test_kernel_build_is_a_span(tmp_path, monkeypatch):
    built = tmp_path / "libdone.so"
    built.write_bytes(b"")
    monkeypatch.setattr(_build, "_target", lambda name: built)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert _build.build("rollout") == {"rollout": ""}
    assert names(span_tree(prof)) == ["kernels.build"]


def test_no_profiler_no_span(monkeypatch):
    """Outside a profiler's session every span is one shared object that never enters
    ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    first, second = profiling.span("policy.act"), profiling.span("kernels.K2")
    assert first is second
    with first:
        pass
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), reward, handler(), device="cpu",
                       **SOLVER)
    action, _, _ = policy.act(np.zeros(S, dtype=np.float32))
    assert action.shape == (U,)


def test_active_span_is_a_record_function(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert isinstance(profiling.span("policy.act"), torch.profiler.record_function)


def test_export_under_a_profiler_has_no_span_node(tmp_path):
    """A span opened while ``torch.export`` traces is the no-op, even with a profiler
    running, and the exported graph holds no profiler node."""
    seen = []

    class Step(torch.nn.Module):
        def forward(self, x):
            opened = profiling.span("models.step")
            seen.append(opened)
            with opened:
                return torch.tanh(x) * 2.0

    with profiling.trace(str(tmp_path)):
        program = torch.export.export(Step(), (torch.ones(3),), strict=False)
    assert seen and all(s is profiling.span("policy.act") for s in seen)
    targets = [str(node.target) for node in program.graph.nodes]
    assert not any("profiler" in t or "record_function" in t for t in targets), targets
    torch.testing.assert_close(program.module()(torch.zeros(3)), torch.zeros(3))
