"""DreamerV3's RSSM (``blackbox_mpc_torch/models/rssm.py``) held to the plain reference
``references/dreamerv3_rssm.py`` on the CPU, on one intra-op thread, at a small size (hidden and
units 32, deter 256 in 8 blocks, 4 codes of 4 classes, obs 5, action 2): the block-diagonal
layer against the dense block matrix it stands for; the core, prior, posterior, encoder and
decoded reward; the inverse-CDF sampler on the same uniforms, and its law by frequencies;
three ``act()``s through ``MPCPolicy`` on ``"auto"`` (the eager path) against PlaNet's CEM
written out over the reference with the policy's draws, common across a solve's evaluations;
the belief carried across them, ``reset()`` and ``plan()`` leaving it; the spans and counters;
the backends the model refuses; the 200M configuration's shapes on the meta device.

Tolerance: both sides compute in float32 from the same weights in another order (``addmm`` and
``baddbmm`` against products and adds group by group), a few ulp a layer; each RMSNorm brings
its layer back to unit scale and the GRU's gates are bounded, so nothing grows along a step.
``RTOL``/``ATOL`` allow 100 times that. The codes compare exactly: at this size no uniform
lies within rounding of a cumulative sum, so both sides draw the same classes (a pick that did
would show as a mismatch). The plans compare at ``PLAN_TOL``: with the same codes the returns
lie some 1e-7 apart, and at population 64 no two lie that close at the elite boundary.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import rssm
from blackbox_mpc_torch.ops.backend_select import choose_backend
from references import dreamerv3_rssm as ref

SMALL = rssm.RSSMConfig(obs_dim=5, action_dim=2, deter=256, hidden=32, stoch=4, classes=4,
                        blocks=8, units=32)
REF = dataclasses.asdict(SMALL)
# The 200M model: size200m's widths with rssm.py's defaults, on cheetah-run.
DREAMERV3_200M = rssm.RSSMConfig(obs_dim=17, action_dim=6)
RTOL, ATOL = 1e-5, 1e-6
PLAN_TOL = 1e-5
H, POP, ELITES, ITERS = 4, 64, 8, 3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def params(seed: int = 0) -> dict:
    return rssm.init_params(SMALL, torch.Generator().manual_seed(seed))


def model(seed: int = 0) -> rssm.RSSMWorldModel:
    return rssm.RSSMWorldModel(SMALL, device="cpu", params=params(seed))


def close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def inputs(rows: int = 9, seed: int = 1):
    """A feature with a nonzero ``h`` and one-hot codes, an action past the bounds in places,
    an observation and uniforms."""
    g = torch.Generator().manual_seed(seed)
    h = torch.tanh(torch.randn(rows, SMALL.deter, generator=g))
    codes = torch.randint(SMALL.classes, (rows, SMALL.stoch), generator=g)
    feat = torch.cat([h, ref.one_hot(codes, REF)], -1)
    a = torch.randn(rows, SMALL.action_dim, generator=g) * 1.5
    obs = torch.randn(rows, SMALL.obs_dim, generator=g) * 3.0
    u = torch.rand(rows, SMALL.stoch, generator=g)
    return feat, a, obs, u


# --------------------------------------------------------------------------- the parts

def test_the_block_layer_is_its_block_diagonal_dense_matrix():
    g = torch.Generator().manual_seed(2)
    layer = {"w": torch.randn(8, 5, 3, generator=g), "b": torch.randn(8, 3, generator=g)}
    x = torch.randn(7, 8 * 5, generator=g)
    dense = torch.block_diag(*layer["w"])  # [40, 24]
    got = rssm.block_linear(x.reshape(7, 8, 5).transpose(0, 1), layer)  # [8, 7, 3]
    close(got.transpose(0, 1).reshape(7, 24), x @ dense + layer["b"].reshape(-1))
    close(ref.block_linear(x, layer), x @ dense + layer["b"].reshape(-1))


@pytest.mark.parametrize("part", ["core", "prior", "posterior", "encode", "reward",
                                  "prediction"])
def test_each_part_against_the_reference(part):
    p = params()
    feat, a, obs, _ = inputs()
    h, z = feat[:, :SMALL.deter], feat[:, SMALL.deter:]
    e = ref.encode(p, REF, obs)
    got, want = {
        "core": lambda: (rssm.core(SMALL, p, h, z, a), ref.core(p, REF, h, z, a)),
        "prior": lambda: (rssm.prior_probs(SMALL, p, h), ref.prior_probs(p, REF, h)),
        "posterior": lambda: (rssm.posterior_probs(SMALL, p, h, e),
                              ref.posterior_probs(p, REF, h, e)),
        "encode": lambda: (rssm.encode(SMALL, p, obs), e),
        "reward": lambda: (rssm.reward(SMALL, p, feat), ref.reward(p, REF, feat)),
        "prediction": lambda: (rssm.step(SMALL, p, feat, a), ref.imagine(p, REF, feat, a)[0]),
    }[part]()
    close(got, want)
    # Not a constant: the part moves with its input.
    assert float(want.std(0).max()) > 1e-3


def test_the_gru_keeps_the_update_bias_and_unimix_floors_every_class():
    p = params()
    feat, a, _, _ = inputs()
    h, z = feat[:, :SMALL.deter], feat[:, SMALL.deter:]
    # With the candidate's and update's weights zero, h' = s(b_v - 1) tanh(s(b_r) b_c) + ...:
    # at zero biases, s(-1) * 0 + (1 - s(-1)) * h.
    q = {**p, "core_gru": [{"w": torch.zeros_like(p["core_gru"][0]["w"]),
                            "b": torch.zeros_like(p["core_gru"][0]["b"])}]}
    keep = 1.0 - 1.0 / (1.0 + math.exp(1.0))
    close(rssm.core(SMALL, q, h, z, a), keep * h)
    probs = rssm.prior_probs(SMALL, p, h)
    assert float(probs.min()) >= 0.01 / SMALL.classes * (1 - 1e-6)
    close(probs.sum(-1), torch.ones(probs.shape[:2]))


def test_the_sampler_against_the_reference_and_its_law():
    p = params()
    feat, _, _, u = inputs(rows=64)
    probs = rssm.prior_probs(SMALL, p, feat[:, :SMALL.deter])
    codes = rssm.sample_codes(probs, u)
    index, _, _ = ref.pick(ref.prior_probs(p, REF, feat[:, :SMALL.deter]), u)
    assert torch.equal(codes, ref.one_hot(index, REF))
    assert torch.equal(codes.reshape(64, SMALL.stoch, -1).sum(-1), torch.ones(64, SMALL.stoch))
    # The law: 40 000 draws of one row's codes against its probabilities (4 sigma).
    n = 40_000
    u = torch.rand(n, SMALL.stoch, generator=torch.Generator().manual_seed(7))
    row = probs[:1].expand(n, -1, -1)
    freq = rssm.sample_codes(row, u).reshape(n, SMALL.stoch, -1).mean(0)
    sigma = torch.sqrt(probs[0] * (1 - probs[0]) / n)
    assert bool((torch.abs(freq - probs[0]) <= 4 * sigma + 1e-7).all())
    # A uniform past the last cumulative sum (rounding can leave it below 1) takes the last.
    last = rssm.sample_codes(probs[:1], torch.ones(1, SMALL.stoch))
    assert bool((last.reshape(SMALL.stoch, -1)[:, -1] == 1).all())


def test_the_filter_step_against_the_reference():
    p = params()
    feat, a, obs, u = inputs()
    want, ties, mismatches = ref.observe(p, REF, feat, a, obs, u)
    close(rssm.observe(SMALL, p, feat, a, obs, u), want)
    assert (ties, mismatches) == (0, 0)


# --------------------------------------------------------------------------- act()

def policy(m, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=SMALL.action_dim), m.reward_fn, m,
                     planning_horizon=H, population=POP, num_elite=ELITES,
                     max_iterations=ITERS, alpha=0.0, device="cpu", seed=11, **kwargs)


def reference_act(p, obs, belief, state, gen_state, noise_state):
    """One ``act()`` over the reference with the policy's draws: the posterior's uniforms and
    then one ``[H, P, stoch]`` draw of the codes' uniforms from the noise generator (every
    evaluation reads the same), the candidates' truncated normals from the planner's."""
    gen, noise = torch.Generator(), torch.Generator()
    gen.set_state(gen_state)
    noise.set_state(noise_state)
    u_filter = torch.rand((1, SMALL.stoch), generator=noise)
    u = torch.rand((H, POP, SMALL.stoch), generator=noise)
    feat, _, _ = ref.observe(p, REF, belief.feat, belief.action, torch.as_tensor(obs)[None],
                             u_filter)
    draws = [ref.truncated_normals(gen, (POP, 1, H, SMALL.action_dim)) for _ in range(ITERS)]
    action, _, ties, mismatches = ref.cem_act(p, REF, feat, state.mean, state.variance, draws,
                                              u, ELITES, 0.0, -1.0, 1.0)
    next_feat = ref.imagine(p, REF, feat, action)[0]
    return action, next_feat, ref.reward(p, REF, next_feat), feat


def test_three_acts_on_auto_against_the_reference():
    m = model()
    p = policy(m, rollout_backend="auto")
    assert p.rollout_backend == "eager"
    g = np.random.default_rng(4)
    for t in range(3):
        obs = (g.normal(size=SMALL.obs_dim) * 2.0).astype(np.float32)
        before = p.belief
        action, next_feat, r, feat = reference_act(
            m.dynamics_params, obs, before, p._solver_state, p._generator.get_state(),
            p._noise_generator.get_state())
        got = p.act(obs, t)
        for x, want in zip(got, (action, next_feat, r)):
            np.testing.assert_allclose(x, want[0].numpy(), rtol=PLAN_TOL, atol=PLAN_TOL)
        assert next_feat.shape == (1, SMALL.feat_dim)
        # The belief carried: the filtered feature (codes exactly) and the returned action.
        close(p.belief.feat, feat)
        assert torch.equal(p.belief.feat[:, SMALL.deter:], feat[:, SMALL.deter:])
        np.testing.assert_array_equal(p.belief.action[0].numpy(), got[0])
        assert before.feat is not p.belief.feat  # replaced, not written in place
    assert (m.observes, m.belief_resets) == (3, 1)


def test_the_draws_are_common_across_a_solves_evaluations():
    m = model()
    p = policy(m)
    seen = []
    inner = p._evaluation_draws

    def record(horizon, rows):
        draws = inner(horizon, rows)
        seen.append(draws[0].clone())
        return draws

    p._evaluation_draws = record
    p.act(np.zeros(SMALL.obs_dim, np.float32))
    p.act(np.ones(SMALL.obs_dim, np.float32))
    assert len(seen) == 2 * ITERS and seen[0].shape == (H, POP, SMALL.stoch)
    assert all(torch.equal(x, seen[0]) for x in seen[1:ITERS])
    assert all(torch.equal(x, seen[ITERS]) for x in seen[ITERS + 1:])
    assert not torch.equal(seen[0], seen[ITERS])  # the next solve draws anew


def test_the_belief_across_acts_reset_and_plan():
    m = model()
    p = policy(m)
    zero = p.belief
    assert float(zero.feat.abs().max()) == 0.0 and float(zero.action.abs().max()) == 0.0
    obs = [np.full(SMALL.obs_dim, v, np.float32) for v in (0.5, -1.0, 2.0)]
    p.act(obs[0])
    first = p.belief
    # plan() filters from the same belief and keeps nothing: belief, solver state, generators.
    states = (p._generator.get_state(), p._noise_generator.get_state(), p._solver_state)
    plan, expected = p.plan(obs[1])
    assert plan.shape == (1, H, SMALL.action_dim) and np.isfinite(expected).all()
    assert p.belief is first and m.observes == 2
    assert torch.equal(p._generator.get_state(), states[0])
    assert torch.equal(p._noise_generator.get_state(), states[1])
    assert p._solver_state is states[2]
    # The next act() filters from the first act()'s belief, as if plan() had not run.
    twin = policy(model())
    twin.act(obs[0])
    for q in (p, twin):
        q.act(obs[1])
        q.act(obs[2])
    assert torch.equal(p.belief.feat, twin.belief.feat)
    p.reset()
    assert float(p.belief.feat.abs().max()) == 0.0 and m.belief_resets == 2
    # After reset() the filter starts from zeros: the first call's feature again, given the
    # same noise draw.
    fresh = policy(model())
    p._noise_generator.set_state(fresh._noise_generator.get_state())
    p._generator.set_state(fresh._generator.get_state())
    p.act(obs[0])
    fresh.act(obs[0])
    assert torch.equal(p.belief.feat, fresh.belief.feat)


def test_the_spans_and_counters_of_an_eager_act(tmp_path):
    from blackbox_mpc_torch.utils import profiling

    m = model()
    p = policy(m)
    obs = np.zeros(SMALL.obs_dim, np.float32)
    p.act(obs)
    with profiling.trace(str(tmp_path)) as prof:
        p.act(obs, 1)
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names.count("models.observe") == 1
    assert names.count("models.step") == ITERS * H
    assert names.count("models.reward") == ITERS * H + 1  # and the lookahead's
    assert (m.observes, m.belief_resets) == (2, 1)


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_the_kernel_backends_are_refused(backend):
    with pytest.raises(ValueError, match="RSSMConfig.*'eager'"):
        policy(model(), rollout_backend=backend)


def test_a_mesh_is_refused():
    class Mesh:
        device = torch.device("cpu")
        shape = {"pop": 2}

    with pytest.raises(ValueError, match="mesh"):
        policy(model(), mesh=Mesh())


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_auto_picks_eager_for_the_rssm(platform):
    assert choose_backend(DREAMERV3_200M, 1000, 1, platform=platform, horizon=12, dim_u=6,
                          solver_name="CEM") == "eager"


# --------------------------------------------------------------------------- the 200M model

def test_the_200m_shapes_and_count_on_the_meta_device():
    shapes = rssm.param_shapes(DREAMERV3_200M)
    widths = {head: [tuple(layer["w"]) for layer in layers] for head, layers in shapes.items()}
    assert widths == {
        "encoder": [(17, 1024), (1024, 1024), (1024, 1024)],
        "core_in": [(8192, 1024), (2048, 1024), (6, 1024)],
        "core_hidden": [(8, 4096, 1024)],
        "core_gru": [(8, 1024, 3072)],
        "prior": [(8192, 1024), (1024, 1024), (1024, 2048)],
        "posterior": [(9216, 1024), (1024, 2048)],
        "reward": [(10240, 1024), (1024, 255)],
    }
    held = {head: [{k: torch.empty(s, device="meta") for k, s in layer.items()}
                   for layer in layers] for head, layers in shapes.items()}
    matrices = {head: sum(layer["w"].numel() for layer in layers)
                for head, layers in held.items()}
    # The issue's table: the core's matrices 69.2 M (the block layers 58.7 M of them), the
    # prior's 11.5 M, the reward's 10.7 M, the encoder's 2.1 M, the posterior's 11.5 M.
    core = matrices["core_in"] + matrices["core_hidden"] + matrices["core_gru"]
    assert core == 69_212_160
    assert matrices["core_hidden"] + matrices["core_gru"] == 58_720_256
    assert [matrices[h] for h in ("prior", "reward", "encoder", "posterior")] == [
        11_534_336, 10_746_880, 2_114_560, 11_534_336]
    everything = sum(t.numel() for layers in held.values() for layer in layers
                     for t in layer.values())
    assert everything == 105_208_063  # with the biases and RMSNorm scales: 0.42 GB float32
    m = rssm.RSSMWorldModel(DREAMERV3_200M, device="meta", params=held)
    assert m.dynamics_params is held and DREAMERV3_200M.feat_dim == 10240
