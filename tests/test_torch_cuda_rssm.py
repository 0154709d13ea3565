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

On the card the core's block layers run on the tensor-core kernel (``ops/block_gemm.py``),
which has no fallback: at size200m's two shapes and 1, 104 and 1000 rows, its error against a
float64 product of the same inputs is at most 4x that of ``torch.baddbmm`` in float32, measured
beside it; two launches and a captured graph's replay give the same bits; an edited or new
weight is packed anew; ``MID`` (deter 1024: 128 units a group) takes it on the policy's path,
graphed and eager alike; a width it does not tile, or a gradient to record, raises, and a
policy over ``SMALL`` (64 units a group) is refused.

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
from blackbox_mpc_torch.ops import block_gemm as bg
from blackbox_mpc_torch.rollout import evaluator
from references import dreamerv3_rssm as ref

pytestmark = pytest.mark.cuda

# Block layers of 64 + 3 x 64 -> 64 and 64 -> 192 a group: the kernel tiles neither.
SMALL = rssm.RSSMConfig(obs_dim=17, action_dim=6, deter=512, hidden=64, stoch=8, classes=16,
                        units=64)
# Block layers of 128 + 3 x 64 -> 128 and 128 -> 384 a group: the kernel tiles both.
MID = dataclasses.replace(SMALL, deter=1024)
BLOCK_SHAPES = ((8, 4096, 1024), (8, 1024, 3072))  # size200m's core_hidden and core_gru
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
    model = rssm.RSSMWorldModel(MID, seed=3, device=device)
    graphed = policy_on(model)
    assert graphed.rollout_backend == "eager"
    launches, kernel_launches = rssm.block_linear.tensor_core_launches, bg.block_gemm.launches
    got = acts(graphed, observations())
    # Host launches, two a core step: the filter's and the lookahead's each act(), the first
    # evaluation's and the capture's H steps.
    assert rssm.block_linear.tensor_core_launches - launches == 4 * ACTS + 4 * H
    assert bg.block_gemm.launches - kernel_launches == 4 * ACTS + 4 * H
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
    model = rssm.RSSMWorldModel(MID, seed=3, device=device)
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        eager = traced(policy_on(model), obs[0], 0)
    assert eager.count("models.observe") == 1
    assert eager.count("models.step") == ITERS * H
    assert eager.count("kernels.block") == 2 * ITERS * H + 4  # the filter's, the lookahead's
    assert eager.count("models.reward") == ITERS * H + 1  # and the prediction's
    assert (model.observes, model.belief_resets) == (1, 1)

    p = policy_on(model)
    p.act(obs[1], 1)  # the first evaluation eager, then the capture, then replays
    replayed = traced(p, obs[2], 2)
    assert replayed.count("evaluator.replay") == ITERS
    assert replayed.count("models.observe") == 1 and "models.step" not in replayed
    assert replayed.count("models.reward") == 1  # the prediction's alone
    assert replayed.count("kernels.block") == 4
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

    # The same two act()s graphed (the remat policy above runs eagerly): the same bits.
    launches = rssm.block_linear.tensor_core_launches
    graphed = policy_on(model, horizon=horizon, population=pop, elites=elites)
    graphed.act(obs[0])
    again = graphed.act(obs[1], 1)
    assert graphed.rollout_graphs.replays > 0 and rssm.block_linear.tensor_core_launches > launches
    for x, y in zip(again, (action, next_feat, r)):
        assert np.array_equal(x, y)


def block_inputs(device, groups, fan_in, fan_out, rows, seed=25):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((groups, fan_in, fan_out), generator=gen, device=device) / fan_in ** 0.5
    b = 0.1 * torch.randn((groups, fan_out), generator=gen, device=device)
    x = torch.nn.functional.silu(torch.randn((groups, rows, fan_in), generator=gen,
                                             device=device))
    return x, {"w": w, "b": b}


@pytest.mark.parametrize("rows", [1, 104, 1000])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=["4096x1024", "1024x3072"])
def test_the_block_kernel_against_float64(device, shape, rows):
    groups, fan_in, fan_out = shape
    x, layer = block_inputs(device, groups, fan_in, fan_out, rows)
    launches, kernel_launches = rssm.block_linear.tensor_core_launches, bg.block_gemm.launches
    got = rssm.block_linear(x, layer)
    assert rssm.block_linear.tensor_core_launches == launches + 1
    assert bg.block_gemm.launches == kernel_launches + 1
    exact = torch.baddbmm(layer["b"].double()[:, None, :], x.double(), layer["w"].double())
    library = torch.baddbmm(layer["b"][:, None, :], x, layer["w"])
    err = float((got.double() - exact).abs().max())
    assert err <= 4 * float((library.double() - exact).abs().max())


def test_the_block_kernel_repeats_its_bits_eager_and_graphed(device):
    x, layer = block_inputs(device, 8, 1024, 3072, 1000)
    first = bg.block_gemm(x, layer["w"], layer["b"])
    assert torch.equal(first, bg.block_gemm(x, layer["w"], layer["b"]))
    static = torch.empty_like(first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(bg.block_gemm(x, layer["w"], layer["b"]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, static)


def test_an_edited_or_new_weight_is_packed_anew(device):
    x, layer = block_inputs(device, 8, 320, 128, 104)

    def want(lay):
        return torch.baddbmm(lay["b"][:, None, :], x, lay["w"])

    calls = bg.packed.calls
    before = rssm.block_linear(x, layer)
    layer["w"][3].mul_(-2.0)  # in place: the same tensor, a new version
    edited = rssm.block_linear(x, layer)
    assert bg.packed.calls == calls + 2
    torch.testing.assert_close(edited, want(layer), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(edited, before)
    fresh = {"w": layer["w"].clone() * 0.5, "b": layer["b"].clone()}  # a new params dict
    torch.testing.assert_close(rssm.block_linear(x, fresh), want(fresh), rtol=1e-5, atol=1e-5)
    assert bg.packed.calls == calls + 3


def test_an_edit_in_place_under_graphs_is_read_after_an_eager_evaluation(device, monkeypatch):
    """A policy's graphs are keyed on the weights' versions: after an edit in place the next
    evaluation runs eagerly and packs anew, so a graphed policy keeps the bits of an eager one
    on the edited weights."""
    obs = observations()
    graphed_model = rssm.RSSMWorldModel(MID, seed=3, device=device)
    eager_model = rssm.RSSMWorldModel(MID, seed=3, device=device)
    graphed = policy_on(graphed_model)
    got = acts(graphed, obs[:2])
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        eager = policy_on(eager_model)
        want = acts(eager, obs[:2])
    for model in (graphed_model, eager_model):
        model.dynamics_params["core_gru"][0]["w"].mul_(1.5)
    got += [(*graphed.act(o, t), *graphed.belief) for t, o in enumerate(obs[2:], 2)]
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        want += [(*eager.act(o, t), *eager.belief) for t, o in enumerate(obs[2:], 2)]
    assert graphed.rollout_graphs.captures == 2
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y)


def test_the_block_kernel_raises_where_it_cannot_take(device):
    """No fallback on the card: a width the kernel does not tile and a gradient to record
    raise, launching nothing, and a policy over ``SMALL`` is refused before any call."""
    launches = bg.block_gemm.launches
    x, layer = block_inputs(device, 8, 256, 64, 104)  # SMALL's core_hidden
    with pytest.raises(ValueError, match="does not tile"):
        rssm.block_linear(x, layer)
    x, layer = block_inputs(device, 8, 320, 128, 104)
    with pytest.raises(ValueError, match="no backward"):
        rssm.block_linear(x.requires_grad_(), layer)
    with torch.no_grad():
        rssm.block_linear(x, layer)
    assert bg.block_gemm.launches == launches + 1
    with pytest.raises(ValueError, match="tiles a layer's inputs"):
        policy_on(rssm.RSSMWorldModel(SMALL, seed=3, device=device))
