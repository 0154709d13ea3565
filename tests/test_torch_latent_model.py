"""TD-MPC2's latent world model (``blackbox_mpc_torch/models/latent.py``) held to the plain
reference ``references/tdmpc2_world_model.py`` on the CPU, on one intra-op thread, at a small
size (latent 16, widths 32, 3 encoder layers, 4 Q heads, 101 bins, task 8, obs 5, action 2): the
encoder, the dynamics, the decoded reward, ``pi`` given its normals and the terminal value given
them and the Q pair; one evaluation with the value; three ``act()``s through ``MPCPolicy`` on
``"auto"``, which plans on ``"eager"``, against a CEM written out here over the reference with
the policy's draws. Besides: the 317M configuration's shapes and parameter count on the meta
device, the spans and counters of an eager ``act()``, ``plan()`` read-only, the backends and
meshes the model refuses, and ``rollout_trajectories`` without a terminal value bit for bit the
loop it was before the value came (PETS ``ts_inf`` and a mean ensemble).

Tolerance: both sides compute in float32 from the same weights, in another order (``addmm``
against a product and an add, the fused LayerNorm and softmax against the plain ones), a few
ulp a layer; each LayerNorm brings its layer back to unit scale, so nothing grows along the
heads. ``RTOL``/``ATOL`` allow 100 times that. The plans compare at ``PLAN_TOL``: the
candidates' returns lie some 1e-7 apart, and at population 64 no two candidates' returns lie so
close at the elite boundary, so both keep the same elites and their means agree to rounding.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import latent
from blackbox_mpc_torch.ops.backend_select import choose_backend
from blackbox_mpc_torch.rollout import evaluator
from references import tdmpc2_world_model as ref

SMALL = latent.LatentModelConfig(obs_dim=5, action_dim=2, latent_dim=16, enc_dim=32,
                                 mlp_dim=32, num_enc_layers=3, num_q=4, num_bins=101,
                                 task_dim=8)
REF = dataclasses.asdict(SMALL)
# The 317M model: MODEL_SIZE[317] with config.yaml's constants, on cheetah-run.
TDMPC2_317M = latent.LatentModelConfig(obs_dim=17, action_dim=6, latent_dim=1376,
                                       enc_dim=4096, mlp_dim=4096, num_enc_layers=5, num_q=8)
RTOL, ATOL = 1e-5, 1e-6
PLAN_TOL = 1e-5
H, POP, ELITES, ITERS, GAMMA = 3, 64, 8, 3, 0.99
# The weights' std times 10: 0.2 x sqrt(32) is about the 317M model's 0.02 x sqrt(4096), so
# every head's output moves with its input as much as at full size.
SCALE = 10.0


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_params(seed: int = 0) -> dict:
    params = latent.init_params(SMALL, torch.Generator().manual_seed(seed))
    for head in latent.HEADS:
        for layer in params[head]:
            layer["w"] = layer["w"] * SCALE
    return params


def model(seed: int = 0) -> latent.LatentWorldModel:
    return latent.LatentWorldModel(SMALL, device="cpu", params=small_params(seed))


def close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- the heads

def inputs(rows: int = 9, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(rows, SMALL.obs_dim, generator=g) * 2.0
    a = torch.rand(rows, SMALL.action_dim, generator=g) * 2.0 - 1.0
    eps = torch.randn(rows, SMALL.action_dim, generator=g)
    return obs, a, eps


@pytest.mark.parametrize("part", ["encode", "next", "reward", "pi", "value"])
def test_each_part_against_the_reference(part):
    p = small_params()
    obs, a, eps = inputs()
    z = ref.encode(p, REF, obs)
    pair = torch.tensor([3, 1])
    got, want = {
        "encode": lambda: (latent.encode(SMALL, p, obs), z),
        "next": lambda: (latent.next_latent(SMALL, p, z, a), ref.next_latent(p, REF, z, a)),
        "reward": lambda: (latent.reward(SMALL, p, z, a), ref.reward(p, REF, z, a)),
        "pi": lambda: (latent.pi(SMALL, p, z, eps), ref.pi(p, REF, z, eps)),
        "value": lambda: (latent.terminal_value(SMALL, p, z, eps, pair),
                          ref.value(p, REF, z, eps, pair)),
    }[part]()
    close(got, want)
    # Not a constant: the part moves with its input.
    assert float(want.std(0).max()) > 1e-3


def test_simnorm_groups_and_the_decode():
    x = torch.randn(4, 16)
    z = latent.simnorm(x, 8)
    torch.testing.assert_close(z.reshape(4, 2, 8).sum(-1), torch.ones(4, 2))
    close(z, ref.sim_norm(x, 8))
    logits = torch.full((1, 101), -1e4)
    logits[0, 75] = 0.0  # all the mass on bin 75: 5.0 in linspace(-10, 10, 101)
    close(latent.two_hot_inv(logits, SMALL), torch.tensor([math.exp(5.0) - 1.0]))


def test_one_evaluation_with_the_value():
    m = model()
    evaluate = evaluator.make_trajectory_evaluator(
        lambda s, a: m.dynamics_fn(m.dynamics_params, s, a), m.reward_fn, discount=GAMMA,
        device="cpu",
        terminal_value=lambda z, eps, pair: m.terminal_value(m.dynamics_params, z, eps, pair))
    obs, _, _ = inputs(rows=2)
    z0 = m.encode(obs)
    g = torch.Generator().manual_seed(3)
    plans = torch.rand(POP, 2, H, SMALL.action_dim, generator=g) * 2 - 1
    eps, pair = latent.value_draws(g, POP * 2, SMALL, "cpu")
    got = evaluate(z0, plans, None, eps, pair)
    want = ref.plan_value(m.dynamics_params, REF, z0.repeat(POP, 1),
                          plans.reshape(POP * 2, H, -1), eps, pair, GAMMA).reshape(POP, 2)
    close(got, want)
    assert m.value_calls == 1


# --------------------------------------------------------------------------- act()

def cem_reference(params, obs, mean, var, gen_state, noise_state):
    """One ``act()`` of the port's CEM (alpha 0, warm start) over the reference, with the
    policy's draws: ``(action, next latent, reward, carried mean)``."""
    gen, noise = torch.Generator(), torch.Generator()
    gen.set_state(gen_state)
    noise.set_state(noise_state)
    z0 = ref.encode(params, REF, torch.as_tensor(obs)[None])
    sqrt2 = math.sqrt(2.0)
    lo, hi = math.erf(-2.0 / sqrt2), math.erf(2.0 / sqrt2)
    for _ in range(ITERS):
        u = torch.rand((POP, 1, H, SMALL.action_dim), generator=gen)
        z = torch.clamp(sqrt2 * torch.erfinv(lo + (hi - lo) * u), -2.0, 2.0)
        eps = torch.randn((POP, SMALL.action_dim), generator=noise)
        pair = torch.rand(SMALL.num_q, generator=noise).argsort()[:2]
        cap = torch.minimum(((mean + 1.0) / 2.0) ** 2, ((1.0 - mean) / 2.0) ** 2)
        samples = mean + z * torch.sqrt(torch.minimum(cap, var))
        returns = ref.plan_value(params, REF, z0.repeat(POP, 1), samples[:, 0], eps, pair,
                                 GAMMA)
        elites = samples[torch.topk(returns, ELITES).indices]
        mean = elites.mean(0)
        var = ((elites - mean) ** 2).mean(0)
    action = mean[:, 0]
    carried = torch.cat([mean[:, 1:], mean[:, -1:]], dim=1)
    return (action, ref.next_latent(params, REF, z0, action), ref.reward(params, REF, z0, action),
            carried)


def policy(m, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=SMALL.action_dim), m.reward_fn, m,
                     planning_horizon=H, population=POP, num_elite=ELITES,
                     max_iterations=ITERS, alpha=0.0, warm_start=True, discount=GAMMA,
                     device="cpu", seed=11, **kwargs)


def test_three_acts_on_auto_against_the_reference():
    m = model()
    p = policy(m, rollout_backend="auto")
    assert p.rollout_backend == "eager"
    g = np.random.default_rng(4)
    for t in range(3):
        obs = (g.normal(size=SMALL.obs_dim) * 2.0).astype(np.float32)
        state = p._solver_state
        want = cem_reference(m.dynamics_params, obs, state.mean, state.variance,
                             p._generator.get_state(), p._noise_generator.get_state())
        action, next_z, r = p.act(obs, t)
        for got, expected in zip((action, next_z, r), want):
            np.testing.assert_allclose(got, expected[0].numpy(), rtol=PLAN_TOL,
                                       atol=PLAN_TOL)
        torch.testing.assert_close(p._solver_state.mean, want[3], rtol=PLAN_TOL,
                                   atol=PLAN_TOL)
        assert next_z.shape == (SMALL.latent_dim,)
    assert (m.encodes, m.value_calls) == (3, 3 * ITERS)


def test_plan_is_read_only():
    m = model()
    p = policy(m)
    obs = np.linspace(-1.0, 1.0, SMALL.obs_dim).astype(np.float32)
    states = (p._generator.get_state(), p._noise_generator.get_state())
    plan, expected = p.plan(obs)
    assert plan.shape == (1, H, SMALL.action_dim) and np.isfinite(expected).all()
    assert torch.equal(p._generator.get_state(), states[0])
    assert torch.equal(p._noise_generator.get_state(), states[1])


def test_eager_act_opens_the_model_spans(tmp_path):
    from blackbox_mpc_torch.utils import profiling

    p = policy(model())
    obs = np.zeros(SMALL.obs_dim, np.float32)
    p.act(obs)
    with profiling.trace(str(tmp_path)) as prof:
        p.act(obs, 1)
    events = prof.profiler.kineto_results.events()
    names = [e.name() for e in events if e.is_user_annotation()]
    assert names.count("models.encode") == 1
    assert names.count("models.step") == ITERS * H
    # H in the evaluations and one in the lookahead.
    assert names.count("models.reward") == ITERS * H + 1
    assert names.count("models.value") == ITERS


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_the_kernel_backends_are_refused(backend):
    with pytest.raises(ValueError, match="eager"):
        policy(model(), rollout_backend=backend)


def test_a_mesh_is_refused():
    class Mesh:
        device = torch.device("cpu")
        shape = {"pop": 2}

    with pytest.raises(ValueError, match="mesh"):
        policy(model(), mesh=Mesh())


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_auto_picks_eager_for_a_latent_model(platform):
    assert choose_backend(TDMPC2_317M, 512, 1, platform=platform, horizon=3, dim_u=6,
                          solver_name="CEM") == "eager"


# --------------------------------------------------------------------------- the 317M model

def test_the_317m_shapes_and_count_on_the_meta_device():
    shapes = latent.param_shapes(TDMPC2_317M)
    params = {h: [{k: torch.empty(s, device="meta") for k, s in layer.items()}
                  for layer in shapes[h]] for h in latent.HEADS}
    params["task"] = torch.empty(shapes["task"], device="meta")
    widths = {h: [tuple(layer["w"].shape[-2:]) for layer in params[h]] for h in latent.HEADS}
    assert widths == {
        "encoder": [(113, 4096), (4096, 4096), (4096, 4096), (4096, 4096), (4096, 1376)],
        "dynamics": [(1478, 4096), (4096, 4096), (4096, 1376)],
        "reward": [(1478, 4096), (4096, 4096), (4096, 101)],
        "pi": [(1472, 4096), (4096, 4096), (4096, 12)],
        "q": [(1478, 4096), (4096, 4096), (4096, 101)],
    }
    assert all(layer["w"].shape[0] == 8 for layer in params["q"])
    matrices = sum(layer["w"].numel() for h in latent.HEADS for layer in params[h])
    everything = matrices + sum(t.numel() for h in latent.HEADS for layer in params[h]
                                for k, t in layer.items() if k != "w") + 96
    assert 316.9e6 <= matrices <= 317.2e6  # the published 317M: 316 956 672
    assert everything == 317_285_433  # with the biases, the LayerNorms and the task row
    held = latent.LatentWorldModel(TDMPC2_317M, device="meta", params=params)
    assert held.dynamics_params is params


# --------------------------------------------------------------------------- no value

def earlier_rollout(dynamics_fn, reward_fn, states, actions, discount, noise=None):
    """``rollout_trajectories`` as it was before the terminal value (batch-major, no penalty,
    no remat)."""
    total = torch.zeros(states.shape[0], dtype=states.dtype)
    disc = torch.ones((), dtype=states.dtype)
    for t, a in enumerate(actions.transpose(0, 1)):
        ns = dynamics_fn(states, a) if noise is None else dynamics_fn(states, a, noise[t])
        total = total + disc * reward_fn(states, a, ns)
        disc = disc * discount
        states = ns
    return total


def mlp_reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


@pytest.mark.parametrize("label", ["ts_inf", "mean"])
def test_rollout_without_a_value_keeps_its_bits(label):
    extra = (dict(probabilistic=True, propagation="ts_inf", num_particles=2)
             if label == "ts_inf" else dict(propagation="mean"))
    h = DynamicsHandler(LearnedDynamicsConfig(dim_s=4, dim_u=2, hidden=(16, 16),
                                              ensemble_size=2, **extra), seed=2, device="cpu")
    step = lambda s, a, noise=None: h.dynamics_fn(h.dynamics_params, s, a, noise)  # noqa: E731
    g = torch.Generator().manual_seed(5)
    obs, plans = torch.randn(2, 4, generator=g), torch.rand(10, 2, H, 2, generator=g) * 2 - 1
    k = 2 if label == "ts_inf" else 1
    noise = torch.randn(H, 10 * k * 2, 4, generator=g) if label == "ts_inf" else None
    evaluate = evaluator.make_trajectory_evaluator(step, mlp_reward, discount=GAMMA,
                                                   num_particles=k, device="cpu")
    got = evaluate(obs, plans, noise)
    rows = plans.repeat_interleave(k, dim=0).reshape(10 * k * 2, H, 2)
    want = earlier_rollout(step, mlp_reward, obs.repeat(10 * k, 1), rows, GAMMA, noise)
    assert torch.equal(got, want.reshape(10, k, 2).mean(1) if k > 1 else want.reshape(10, 2))
    flat = evaluator.rollout_trajectories(step, mlp_reward, obs.repeat(10 * k, 1), rows,
                                          discount=GAMMA, noise=noise)
    assert torch.equal(flat, want)


