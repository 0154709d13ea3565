"""DreamerV3's RSSM (``blackbox_mpc_torch/models/rssm.py``) on the card: ``act()``s whose
evaluations replay a CUDA graph against the same ``act()``s on the eager loop, bit for bit
(actions, predictions, the carried belief, both generators' states), with the codes' uniforms as
the graph's inputs; the model's spans and counters; and one ``act()`` at the published widths
(d = 1024: deter 8192 in 8 blocks, 32 codes of 64 classes, 255 reward bins) against PlaNet's
CEM over the plain reference ``references/dreamerv3_rssm.py``.

At those widths the program's probabilities and the reference's lie some rounding apart, so a
uniform that close to a cumulative sum may fall on either side: the reference takes the
program's class within ``MARGIN`` of a cumulative sum (the benchmark cell's tie margin,
``port_bench/reference/rssm.py``) and must draw the program's class everywhere else. With the
same classes the returns lie some 1e-6 apart; ``ACTION_TOL`` is the cell's ``answer`` limit.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_rssm.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import rssm
from blackbox_mpc_torch.rollout import evaluator
from references import dreamerv3_rssm as ref

pytestmark = pytest.mark.cuda

SMALL = rssm.RSSMConfig(obs_dim=17, action_dim=6, deter=512, hidden=64, stoch=8, classes=16,
                        units=64)
H, ITERS, ACTS = 5, 3, 4
MARGIN = 2e-5
ACTION_TOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def policy_on(model, horizon=H, population=128, elites=16, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=model.config.action_dim), model.reward_fn,
                     model, planning_horizon=horizon, population=population,
                     num_elite=elites, max_iterations=ITERS, alpha=0.0,
                     rollout_backend="auto", seed=5, device=model.device, **kwargs)


def observations(n: int = ACTS) -> list:
    g = np.random.default_rng(2)
    return [g.normal(size=17).astype(np.float32) for _ in range(n)]


def acts(policy, obs_list) -> list:
    out = []
    for t, obs in enumerate(obs_list):
        out.append((*policy.act(obs, t), *policy.belief, policy._generator.get_state(),
                    policy._noise_generator.get_state()))
    return out


def test_graphed_acts_equal_eager_bit_for_bit(device, monkeypatch):
    model = rssm.RSSMWorldModel(SMALL, seed=3, device=device)
    graphed = policy_on(model)
    assert graphed.rollout_backend == "eager"
    got = acts(graphed, observations())
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        want = acts(policy_on(model), observations())
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y)
    graphs = graphed.rollout_graphs
    assert (graphs.captures, graphs.replays, graphs.graphs) == (1, ACTS * ITERS - 1, 1)


def test_the_spans_and_counters_on_an_eager_evaluation_and_a_replay(device, tmp_path,
                                                                   monkeypatch):
    from torch.autograd import DeviceType

    from blackbox_mpc_torch.utils import profiling

    def traced(p, o, t):
        with profiling.trace(str(tmp_path / str(t))) as prof:
            p.act(o, t)
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation() and e.device_type() == DeviceType.CPU]

    obs = observations(3)
    model = rssm.RSSMWorldModel(SMALL, seed=3, device=device)
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        eager = traced(policy_on(model), obs[0], 0)
    assert eager.count("models.observe") == 1
    assert eager.count("models.step") == ITERS * H
    assert eager.count("models.reward") == ITERS * H + 1  # and the prediction's
    assert (model.observes, model.belief_resets) == (1, 1)

    p = policy_on(model)
    p.act(obs[1], 1)  # the first evaluation eager, then the capture, then replays
    replayed = traced(p, obs[2], 2)
    assert replayed.count("evaluator.replay") == ITERS
    assert replayed.count("models.observe") == 1 and "models.step" not in replayed
    assert replayed.count("models.reward") == 1  # the prediction's alone
    assert (model.observes, model.belief_resets) == (3, 2)
    p.reset()
    assert model.belief_resets == 3 and float(p.belief.feat.abs().max()) == 0.0


def test_one_act_at_the_published_widths_against_the_reference(device):
    config = rssm.RSSMConfig(obs_dim=17, action_dim=6)
    cfg = dataclasses.asdict(config)
    steps = []

    class Recording(rssm.RSSMWorldModel):
        def dynamics_fn(self, params, feat, a, noise=None):
            out = super().dynamics_fn(params, feat, a, noise)
            if noise is not None:
                steps.append(out[:, config.deter:].reshape(-1, config.stoch, config.classes)
                             .argmax(-1))
            return out

    model = Recording(config, seed=7, device=device)
    pop, elites, horizon = 256, 25, 12
    p = policy_on(model, horizon=horizon, population=pop, elites=elites, remat_rollout=True)
    obs = observations(2)
    p.act(obs[0])  # a belief to carry into the checked call
    steps.clear()
    belief, state = p.belief, p._solver_state
    gen_state, noise_state = p._generator.get_state(), p._noise_generator.get_state()
    action, next_feat, r = p.act(obs[1], 1)

    params = model.dynamics_params
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    noise = torch.Generator(device=device)
    noise.set_state(noise_state)
    u_filter = torch.rand((1, config.stoch), generator=noise, device=device)
    u = torch.rand((horizon, pop, config.stoch), generator=noise, device=device)
    program = p.belief.feat[:, config.deter:].reshape(1, config.stoch, -1).argmax(-1)
    feat, ties, mismatches = ref.observe(params, cfg, belief.feat, belief.action,
                                         torch.as_tensor(obs[1], device=device)[None],
                                         u_filter, program, MARGIN)
    draws = [ref.truncated_normals(gen, (pop, 1, horizon, 6), device) for _ in range(ITERS)]
    classes = [torch.stack(steps[i * horizon:(i + 1) * horizon]) for i in range(ITERS)]
    want, _, plan_ties, plan_mismatches = ref.cem_act(
        params, cfg, feat, state.mean, state.variance, draws, u, elites, 0.0, -1.0, 1.0,
        classes, MARGIN)
    assert mismatches + plan_mismatches == 0
    assert ties + plan_ties <= 100  # of 0.3 M picks
    np.testing.assert_allclose(action, want[0].cpu().numpy(), rtol=0, atol=ACTION_TOL)
    deter = config.deter
    np.testing.assert_allclose(p.belief.feat[:, :deter].cpu().numpy(),
                               feat[:, :deter].cpu().numpy(), rtol=0, atol=1e-5)
    want_feat = ref.imagine(params, cfg, feat, torch.as_tensor(action, device=device)[None])[0]
    np.testing.assert_allclose(next_feat, want_feat[0].cpu().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r, float(ref.reward(params, cfg, want_feat)[0]), rtol=1e-5,
                               atol=1e-5)
