"""A latent world model (``blackbox_mpc_torch/models/latent.py``, TD-MPC2's) on the card: an
``act()`` whose evaluations replay a CUDA graph against the same ``act()`` on the eager loop,
bit for bit (actions, predicted latents and rewards, both generators' states), with the value's
draws as the graph's inputs; and the model's spans and counters, which open and count on an
eager evaluation and not on a replay.

Every test here needs an NVIDIA GPU (``@pytest.mark.cuda``) and skips without one. The file
imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda \
        tests/test_torch_cuda_latent.py -q
"""
import numpy as np
import pytest
import torch

from blackbox_mpc_torch import MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.models import latent
from blackbox_mpc_torch.rollout import evaluator

pytestmark = pytest.mark.cuda

CONFIG = latent.LatentModelConfig(obs_dim=17, action_dim=6, latent_dim=64, enc_dim=128,
                                  mlp_dim=128, num_enc_layers=3, num_q=4)
H, ITERS, ACTS = 3, 3, 4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def policy_on(model) -> MPCPolicy:
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=CONFIG.action_dim), model.reward_fn, model,
                     planning_horizon=H, population=128, num_elite=16, max_iterations=ITERS,
                     alpha=0.0, warm_start=True, discount=0.99, rollout_backend="auto",
                     seed=5, device=model.device)


def observations(n: int = ACTS) -> list:
    g = np.random.default_rng(2)
    return [g.normal(size=CONFIG.obs_dim).astype(np.float32) for _ in range(n)]


def acts(policy, obs_list) -> list:
    out = []
    for t, obs in enumerate(obs_list):
        out.append((*policy.act(obs, t), policy._generator.get_state(),
                    policy._noise_generator.get_state()))
    return out


def test_graphed_act_equals_eager_bit_for_bit(device, monkeypatch):
    model = latent.LatentWorldModel(CONFIG, seed=3, device=device)
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


def test_the_model_spans_open_on_an_eager_evaluation_not_on_a_replay(device, tmp_path,
                                                                      monkeypatch):
    from torch.autograd import DeviceType

    from blackbox_mpc_torch.utils import profiling

    def traced(p, o, t):
        with profiling.trace(str(tmp_path / str(t))) as prof:
            p.act(o, t)
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation() and e.device_type() == DeviceType.CPU]

    obs = observations(3)
    model = latent.LatentWorldModel(CONFIG, seed=3, device=device)
    with monkeypatch.context() as m:
        m.setattr(evaluator, "_graphable", lambda inputs: False)
        eager = traced(policy_on(model), obs[0], 0)
    assert eager.count("models.encode") == 1
    assert eager.count("models.step") == ITERS * H
    assert eager.count("models.reward") == ITERS * H + 1  # and the lookahead's
    assert eager.count("models.value") == ITERS
    assert (model.encodes, model.value_calls) == (1, ITERS)

    p = policy_on(model)
    p.act(obs[1], 1)  # the first evaluation eager, then the capture, then replays
    assert (model.encodes, model.value_calls) == (2, ITERS + 2)
    replayed = traced(p, obs[2], 2)
    assert replayed.count("evaluator.replay") == ITERS
    assert replayed.count("models.encode") == 1
    assert "models.value" not in replayed and "models.step" not in replayed
    assert replayed.count("models.reward") == 1  # the lookahead's alone
    assert (model.encodes, model.value_calls) == (3, ITERS + 2)
