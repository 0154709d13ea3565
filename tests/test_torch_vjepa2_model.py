"""V-JEPA 2-AC's world model (``blackbox_mpc_torch/models/vjepa2_ac.py``) against the plain
reference (``references/vjepa2_ac.py``) on seeded weights at a tiny size: every part, the
rollout through the cache of earlier frames against the reference's forward over every frame,
the goal energy, whole ``act()``s, the graphed evaluator (a CPU fake in the CUDA graph's
place), the goal and ``reset()``, and the backend rules.

Tiny: images 32 x 32 (4 patches a frame), an encoder and a predictor of 2 blocks 64 wide with
4 heads of 16 (RoPE parts of 4, the last 4 units unturned), MLPs 256. The weights' std is 0.08:
0.08 x sqrt(64) is the published 0.02 x sqrt(1024), so attention is as far from uniform as at
full size.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import vjepa2_ac as vj
from blackbox_mpc_torch.ops.backend_select import choose_backend, resolve_backend
from blackbox_mpc_torch.rollout import evaluator
from blackbox_mpc_torch.solvers import SOLVER_REGISTRY
from references import vjepa2_ac as ref
from tests.test_torch_rollout_graphs import FakeGraph

TINY = vj.VJEPA2ACConfig(image_size=32, enc_dim=64, enc_depth=2, enc_heads=4, enc_mlp_dim=256,
                         pred_dim=64, pred_depth=2, pred_heads=4, pred_mlp_dim=256)
REF = dataclasses.asdict(TINY)
SCALE = 4.0
RTOL, ATOL = 2e-5, 2e-5
H, POP, ELITES, ITERS, BOUND = 2, 32, 4, 3, 0.075


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_params(seed: int = 0) -> dict:
    params = vj.init_params(TINY, torch.Generator().manual_seed(seed))
    for part in params.values():
        for tree in (part, part["blocks"]):
            for name in tree:
                if name.endswith("_w") and not name.startswith(("ln", "norm")):
                    tree[name] = tree[name] * SCALE
    return params


def model(seed: int = 0) -> vj.VJEPA2ACWorldModel:
    return vj.VJEPA2ACWorldModel(TINY, device="cpu", params=tiny_params(seed))


def close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def images(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3, TINY.image_size, TINY.image_size), generator=g)


def frames(rows: int, seed: int = 1):
    """Encoded frames, states and actions of ``rows`` rows."""
    g = torch.Generator().manual_seed(seed)
    z = ref.encode(tiny_params(), REF, images(rows, seed))
    s = torch.randn((rows, TINY.state_dim), generator=g) * 0.3
    a = (torch.rand((rows, 3, TINY.action_dim), generator=g) * 2 - 1) * BOUND
    return z, s, a


# --------------------------------------------------------------------------- the parts

def test_rope_against_the_reference_keeps_the_norm():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 6, 16), generator=g)
    positions = ((0, 0, 0), (1, 0, 0), (1, 2, 3), (0, 1, 1), (3, 1, 0), (2, 2, 2))
    got = vj.rotate(x, *vj.rope_tables(16, positions, torch.device("cpu")))
    close(got, ref.rope(x, torch.tensor(positions)))
    close(got.norm(dim=-1), x.norm(dim=-1))
    assert torch.equal(got[..., 0, :], x[..., 0, :])  # position 0 turns nothing
    assert not torch.allclose(got[..., 2, :12], x[..., 2, :12])
    assert torch.equal(got[..., 12:], x[..., 12:])  # 3 parts of 4, the rest unturned


def test_the_reference_patch_embedding_is_conv3d():
    """The reference embeds each patch by one product in ``Conv3d``'s weight order: the same as
    ``Conv3d`` at kernel = stride over the image repeated into a tubelet, as the published
    encoder embeds it."""
    p, x = tiny_params(), images(2, 4)
    t, size = TINY.tubelet_size, TINY.patch_size
    enc = p["encoder"]
    weight = enc["patch_w"].T.reshape(TINY.enc_dim, 3, t, size, size)
    clip = x.unsqueeze(2).repeat(1, 1, t, 1, 1)
    want = torch.nn.functional.conv3d(clip, weight, enc["patch_b"], stride=(t, size, size))
    got = ref.dense(ref.patches(REF, x), enc["patch_w"], enc["patch_b"])
    close(got, want.flatten(2).transpose(1, 2))
    close(vj.patchify(TINY, x), ref.patches(REF, x))


def test_the_encoder_against_the_reference():
    p, x = tiny_params(), images(3, 5)
    z = vj.encode_images(TINY, p, x)
    assert z.shape == (3, TINY.patches, TINY.enc_dim)
    close(z, ref.encode(p, REF, x))
    # Each token's latent is normalised without an affine.
    close(z.mean(-1), torch.zeros(3, TINY.patches))


def test_one_predictor_frame_against_the_reference():
    p = tiny_params()
    z, s, a = frames(5)
    got = vj.predict_frame(TINY, p, z, s, a[:, 0])
    close(got, ref.predict(p, REF, z[:, None], s[:, None], a[:, :1])[:, 0])


@pytest.mark.parametrize("horizon", [2, 3])
def test_the_cached_rollout_against_the_uncached_reference(horizon):
    """Frame k + 1 attends to the cached keys and values of frames <= k: the rollout through
    the model's cache agrees with the reference's block-causal forward over every frame."""
    m, p = model(), tiny_params()
    z, s, a = frames(6)
    rows = torch.cat([z.flatten(1), s], dim=-1)
    state = m.begin_rollout(rows, horizon)
    assert m.kv_cache_bytes == (TINY.pred_depth * 2 * 6 * TINY.frame_tokens * (horizon - 1)
                                * TINY.pred_dim * 4)
    got = []
    for k in range(horizon):
        state = m.dynamics_fn(p, state, a[:, k])
        got.append(state.z)
    want_z, want_s = ref.rollout(p, REF, z, s, a[:, :horizon])
    close(torch.stack(got, 1), want_z)
    close(state.s, want_s[:, -1])
    assert state.frame == horizon and m.predicted_frames == horizon


def test_the_second_frame_reads_the_first_frames_cache():
    """A stale cache (the first frame's keys and values overwritten) moves the second frame
    and only it."""
    m, p = model(), tiny_params()
    z, s, a = frames(4)
    state = m.begin_rollout(torch.cat([z.flatten(1), s], dim=-1), 2)
    first = m.dynamics_fn(p, state, a[:, 0])
    second = m.dynamics_fn(p, first, a[:, 1]).z
    first.cache.normal_()
    assert not torch.allclose(m.dynamics_fn(p, first, a[:, 1]).z, second)


def test_the_energy_and_the_terminal_value():
    m = model()
    z, s, _ = frames(4)
    goal = ref.encode(tiny_params(), REF, images(1, 9))[0]
    close(vj.goal_energy(z, goal), ref.energy(z, goal))
    rows = torch.cat([z.flatten(1), s], dim=-1)
    close(m.terminal_value(m.dynamics_params, rows, goal), -ref.energy(z, goal))
    state = m.begin_rollout(rows, 1)
    close(m.terminal_value(m.dynamics_params, state, goal), -ref.energy(z, goal))


# --------------------------------------------------------------------------- planning

def obs_row(seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    image = g.uniform(0.0, 1.0, 3 * TINY.image_size ** 2)
    return np.concatenate([image, g.normal(size=TINY.state_dim) * 0.3]).astype(np.float32)


def policy(m, **kwargs) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-BOUND, BOUND, dim=TINY.action_dim), m.reward_fn, m,
                     planning_horizon=H, population=POP, num_elite=ELITES,
                     max_iterations=ITERS, alpha=0.0, device="cpu", seed=11, **kwargs)


def cem_reference(params, obs, goal_image, mean, var, gen_state):
    """One ``act()`` of the port's CEM over the reference with the policy's draws:
    ``(action, the next planning row, the plan's elites' mean value)``."""
    gen = torch.Generator()
    gen.set_state(gen_state)
    image = torch.as_tensor(obs[:-TINY.state_dim]).reshape(1, 3, TINY.image_size,
                                                          TINY.image_size)
    s0 = torch.as_tensor(obs[-TINY.state_dim:])[None]
    z0 = ref.encode(params, REF, image)
    goal = ref.encode(params, REF, torch.as_tensor(goal_image).reshape(image.shape))[0]
    draws = [ref.truncated_normals(gen, (POP, 1, H, TINY.action_dim)) for _ in range(ITERS)]
    action, _, value = ref.cem_act(params, REF, z0, s0, goal, mean, var, draws, ELITES, 0.0,
                                   -BOUND, BOUND)
    z1 = ref.predict(params, REF, z0[:, None], s0[:, None], action[:, None])[:, 0]
    return action, torch.cat([z1.flatten(1), s0 + action], dim=-1), value


def test_three_acts_on_auto_against_the_reference():
    m = model()
    p = policy(m, rollout_backend="auto")
    assert p.rollout_backend == "eager"
    goal = obs_row(40)[:-TINY.state_dim]
    m.set_goal(goal)
    for t in range(3):
        obs = obs_row(t)
        state = p._solver_state
        want = cem_reference(m.dynamics_params, obs, goal, state.mean, state.variance,
                             p._generator.get_state())
        # The solve's own value of its plan, the last iteration's elites' mean (plan() draws
        # from copies of the generators: act() then draws the same).
        _, expected = p.plan(obs, t)
        np.testing.assert_allclose(expected, want[2].numpy(), rtol=1e-5)
        action, next_row, r = p.act(obs, t)
        np.testing.assert_allclose(action, want[0][0].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(next_row, want[1][0].numpy(), rtol=RTOL, atol=ATOL)
        assert r == 0.0 and next_row.shape == (TINY.dim_s,)
    assert (m.encodes, m.goal_encodes) == (6, 1)
    # Per act: H frames in each of ITERS evaluations, and the one-step lookahead.
    assert m.predicted_frames == 6 * (ITERS * H + 1)


def test_set_goal_and_reset():
    m = model()
    p = policy(m)
    obs = obs_row(1)
    with pytest.raises(RuntimeError, match="set_goal"):
        p.act(obs)
    m.set_goal(obs_row(2)[:-TINY.state_dim])
    first = m.goal
    _, value_a = p.plan(obs)
    m.set_goal(torch.as_tensor(obs_row(3)[:-TINY.state_dim]))
    assert m.goal_encodes == 2 and not torch.equal(m.goal, first)
    _, value_b = p.plan(obs)
    assert value_a != value_b  # the solve reads the new goal
    warm = policy(m, warm_start=True)
    goal = m.goal
    warm.act(obs)
    assert not torch.equal(warm._solver_state.mean, torch.zeros_like(goal[:H, :TINY.action_dim]))
    warm.reset()
    # reset() restarts the solver's state (the midpoint of the bounds) and keeps the goal.
    assert torch.equal(warm._solver_state.mean, torch.zeros((1, H, TINY.action_dim)))
    assert m.goal is goal and m.goal_encodes == 2


def test_graph_replays_against_the_eager_evaluation(monkeypatch):
    """The graphed evaluator captures once and replays every later evaluation, its inputs
    the goal and the rows, and answers as the eager path does; the model's cache is no working
    memory of a graph: on a card whose 1/16 it alone passes, the shape is still captured."""
    eager = policy(model())
    eager.dynamics_handler.set_goal(obs_row(7)[:-TINY.state_dim])
    want = [eager.act(obs_row(t), t) for t in range(2)]
    m = model()
    graphed = policy(m)
    m.set_goal(obs_row(7)[:-TINY.state_dim])
    monkeypatch.setattr(evaluator, "_on_card", lambda x: True)
    monkeypatch.setattr(evaluator, "_Graph", FakeGraph)
    cache = TINY.pred_depth * 2 * POP * TINY.frame_tokens * (H - 1) * TINY.pred_dim * 4
    monkeypatch.setattr(evaluator, "_memory", lambda device, release=False: (
        m.rollout_buffer_bytes(), 8 * cache))
    got = [graphed.act(obs_row(t), t) for t in range(2)]
    g = graphed.rollout_graphs
    assert (g.captures, g.replays, g.graphs) == (1, 2 * ITERS - 1, 1)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert m.kv_cache_bytes == m.rollout_buffer_bytes() > 0


def test_the_model_spans_and_counters(tmp_path):
    from blackbox_mpc_torch.utils import profiling

    m = model()
    p = policy(m)
    obs = obs_row(0)
    with profiling.trace(str(tmp_path)) as prof:
        m.set_goal(obs_row(1)[:-TINY.state_dim])
        p.act(obs)
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    frames_ = ITERS * H + 1
    assert names.count("models.goal") == 1 and names.count("models.encode") == 1
    assert names.count("models.predict") == frames_
    assert names.count("models.step") == ITERS * H
    assert names.count("models.value") == ITERS
    # Every attention call: the goal's and the observation's encoders and each frame's blocks.
    assert names.count("models.attend") == 2 * TINY.enc_depth + frames_ * TINY.pred_depth


# --------------------------------------------------------------------------- the backends

CONFIG = vj.VJEPA2ACConfig()


def cem_config(**kw):
    return SOLVER_REGISTRY["CEM"][0](planning_horizon=2, population=128, num_elite=10,
                                     max_iterations=3, alpha=0.0, **kw)


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_auto_picks_the_eager_path(platform):
    assert choose_backend(CONFIG, 128, 1, platform=platform, horizon=2, dim_u=7,
                          solver_name="CEM", solver_config=cem_config()) == "eager"
    assert resolve_backend("auto", CONFIG, False, "CEM", cem_config(), 1, 2, 7,
                           platform=platform) == "eager"


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_the_kernel_backends_are_refused_by_name(backend):
    with pytest.raises(ValueError, match="VJEPA2ACConfig"):
        resolve_backend(backend, CONFIG, False, "CEM", cem_config(), 1, 2, 7, platform="cuda")
    with pytest.raises(ValueError, match="VJEPA2ACConfig"):
        policy(model(), rollout_backend=backend)


@pytest.mark.parametrize("name", ["Gradient", "CEM-GD"])
def test_the_first_order_solvers_are_refused(name):
    sc = SOLVER_REGISTRY[name][0](planning_horizon=2, population=8)
    for platform in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="first-order"):
            resolve_backend("auto", CONFIG, False, name, sc, 1, 2, 7, platform=platform)


def test_a_mesh_is_refused():
    class Mesh:
        device = torch.device("cpu")
        shape = {"pop": 2}

    with pytest.raises(ValueError, match="mesh"):
        policy(model(), mesh=Mesh())


# --------------------------------------------------------------------------- the sizes

def test_the_published_sizes_on_the_meta_device():
    shapes = vj.param_shapes(CONFIG)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

    assert CONFIG.patches == 256 and CONFIG.frame_tokens == 258
    assert round(count(shapes["encoder"]) / 1e6) == 1012  # ViT-g/16: 1.012 B
    assert round(count(shapes["predictor"]) / 1e6) == 305  # the "~300M" predictor
    m = vj.VJEPA2ACWorldModel(CONFIG, device="meta", params={})
    state = m.begin_rollout(torch.empty((128, CONFIG.dim_s), device="meta"), 2)
    # 24 blocks x K, V x 128 rows x 258 tokens x 1024 x 4 bytes: 6.49 GB.
    assert m.kv_cache_bytes == 24 * 2 * 128 * 258 * 1024 * 4 == 6_492_782_592
    assert state.cache.shape == (24, 2, 128, 16, 258, 64)
