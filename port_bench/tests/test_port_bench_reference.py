"""The plain references against themselves and against other ways of computing the same at
small sizes: the draws follow a generator's state, the ensemble's propagations, the member
assignment, and the trainer's Adam against ``torch.optim.Adam``."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import streams
from port_bench.reference import model as ref_model
from port_bench.reference import planning, training

HERE = Path(__file__).resolve().parent.parent


def tiny(config: str, **model):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg["model"] = {**cfg["model"], "hidden": [8, 8], **model}
    return cfg


def model_of(cfg, seed=3):
    return ref_model.Model(cfg, streams.make_weights(cfg, seed, "cpu"),
                           streams.make_stats(cfg, seed), "cpu")


def test_member_ids_are_balanced_and_fixed():
    ids = ref_model.ts_member_ids(40, 5)
    assert np.bincount(ids).tolist() == [8] * 5
    assert ids.tolist() == ref_model.ts_member_ids(40, 5).tolist()
    assert ids.tolist() != np.tile(np.arange(5), 8).tolist()


def test_mean_step_averages_the_members():
    cfg = tiny("cheetah_cem_3x500")
    m = model_of(cfg)
    g = torch.Generator().manual_seed(0)
    s, a = torch.randn((7, 17), generator=g), torch.rand((7, 6), generator=g)
    one_by_one = []
    for e in range(5):
        h = m.net_input(s, a)
        for i, (w, b) in enumerate(m.layers):
            h = h @ w[e] + b[e]
            if i < len(m.layers) - 1:
                h = torch.tanh(h)
        one_by_one.append(h)
    want = m.to_state(s, torch.stack(one_by_one).mean(0))
    torch.testing.assert_close(m.mean_step(s, a), want, rtol=1e-6, atol=1e-6)


def test_sampled_step_runs_each_row_through_its_member():
    cfg = tiny("pets_halfcheetah", num_particles=2)
    m = model_of(cfg)
    rows = 10
    g = torch.Generator().manual_seed(1)
    s, a = torch.randn((rows, 18), generator=g), torch.rand((rows, 6), generator=g)
    noise = torch.randn((rows, 18), generator=g)
    got = m.sampled_step(s, a, m.member_rows(rows), noise)
    ids = ref_model.ts_member_ids(rows, 5)
    x = m.net_input(s, a)
    for r in range(rows):
        h = x[r]
        for i, (w, b) in enumerate(m.layers):
            h = h @ w[ids[r]] + b[ids[r]]
            if i < len(m.layers) - 1:
                h = h * torch.sigmoid(h)
        mean, logvar = h[:18], m.bounded_logvar(h[18:])
        want = m.to_state(s[r], mean + torch.exp(0.5 * logvar) * noise[r])
        torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-5)


def test_bounded_logvar_stays_in_the_band():
    cfg = tiny("pets_halfcheetah")
    m = model_of(cfg)
    lv = m.bounded_logvar(torch.linspace(-50.0, 50.0, 18))
    # Soft bounds: the top is lv_min + softplus(lv_max - lv_min), 2.8e-5 above lv_max.
    top = -10.0 + float(torch.nn.functional.softplus(torch.tensor(10.5)))
    assert float(lv.min()) >= -10.0 - 1e-6 and float(lv.max()) <= top + 1e-6


@pytest.mark.parametrize("config, traffic", [
    ("cheetah_cem_3x500", {"solver": "CEM", "solver_kwargs": {
        "population": 30, "num_elite": 4, "max_iterations": 3, "alpha": 0.25}}),
    ("cheetah_cem_3x500", {"solver": "RandomSearch", "solver_kwargs": {"population": 30}}),
    ("pets_halfcheetah", {"solver": "CEM", "solver_kwargs": {
        "population": 10, "num_elite": 3, "max_iterations": 2, "alpha": 0.1}}),
])
def test_plan_step_follows_the_generator(config, traffic):
    cfg = tiny(config, **({"num_particles": 2} if config == "pets_halfcheetah" else {}))
    traffic = dict(traffic, planning_horizon=4)
    m = model_of(cfg)
    s = cfg["model"]["dim_s"]
    obs = torch.randn((1, s), generator=torch.Generator().manual_seed(2))
    mean, var = torch.zeros((1, 4, 6)), torch.full((1, 4, 6), 0.25)
    gens = [torch.Generator().manual_seed(k) for k in (5, 6)]
    states = [g.get_state() for g in gens]
    (a1, f1), = planning.plan_step(m, cfg, traffic, obs, mean, var, *states, tie=0.0)
    (a2, f2), = planning.plan_step(m, cfg, traffic, obs, mean, var, *states, tie=0.0)
    assert torch.equal(a1, a2)
    assert float(a1.abs().max()) <= 1.0
    other = torch.Generator().manual_seed(7).get_state()
    (a3, _), = planning.plan_step(m, cfg, traffic, obs, mean, var, other, states[1], tie=0.0)
    assert not torch.equal(a1, a3)
    if traffic["solver"] == "CEM":
        assert torch.equal(a1, f1[:, 0])


def test_random_search_returns_its_best_candidate():
    cfg = tiny("cheetah_cem_3x500")
    traffic = {"solver": "RandomSearch", "solver_kwargs": {"population": 16},
               "planning_horizon": 3}
    m = model_of(cfg)
    obs = torch.zeros((1, 17))
    state = torch.Generator().manual_seed(9).get_state()
    (action, _), = planning.plan_step(m, cfg, traffic, obs, None, None, state, state, tie=0.0)
    g = torch.Generator()
    g.set_state(state)
    samples = -1.0 + torch.rand((16, 1, 3, 6), generator=g) * 2.0
    returns = []
    for c in range(16):
        s, total = obs, 0.0
        for t in range(3):
            ns = m.mean_step(s, samples[c, :, t])
            total += float(planning.reward(cfg, s, samples[c, :, t], ns))
            s = ns
        returns.append(total)
    torch.testing.assert_close(action[0], samples[int(np.argmax(returns)), 0, 0])


def test_adam_steps_match_torch_optim():
    cfg = tiny("pets_halfcheetah")
    weights = streams.make_weights(cfg, 4, "cpu")
    stats = streams.make_stats(cfg, 4)
    g = torch.Generator().manual_seed(3)
    batches = [tuple(torch.randn((5, 6, d), generator=g) for d in (18, 6, 18))
               for _ in range(3)]
    losses, first, after = training.adam_steps(cfg, weights, stats, batches, 1e-3)
    params = [t.clone().requires_grad_(True) for t in training.leaves(weights)]
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for step, (s, a, ns) in enumerate(batches):
        opt.zero_grad()
        m = ref_model.Model(cfg, training._Trainable(params, True), stats, "cpu")
        per_member = training.member_losses(cfg, m, s, a, ns)
        torch.testing.assert_close(per_member.detach(), losses[step])
        (per_member.sum() + 0.01 * (params[-1].mean() - params[-2].mean())).backward()
        if step == 0:
            for p, f in zip(params, first):
                torch.testing.assert_close(p.grad, f)
        opt.step()
    for p, a in zip(params, after):
        torch.testing.assert_close(p.detach(), a, rtol=1e-5, atol=1e-7)


def test_half_batch_reads_half_the_rows():
    cfg = tiny("pets_halfcheetah")
    m = model_of(cfg)
    g = torch.Generator().manual_seed(5)
    s, a, ns = (torch.randn((5, 8, d), generator=g) for d in (18, 6, 18))
    torch.testing.assert_close(training.member_losses(cfg, m, s, a, ns, half=True),
                               training.member_losses(cfg, m, s[:, :4], a[:, :4], ns[:, :4]))


def test_fit_stats_is_the_population_std():
    rng = np.random.default_rng(0)
    s, a, ns = rng.normal(size=(50, 3)), rng.normal(size=(50, 2)), rng.normal(size=(50, 3))
    st = training.fit_stats(s, a, ns)
    np.testing.assert_allclose(st["std_targets"], (ns - s).std(0), rtol=1e-6)
    np.testing.assert_allclose(st["mean_actions"], a.mean(0), rtol=1e-6)


def test_a_tie_at_the_elite_boundary_is_followed_both_ways():
    returns = torch.tensor([[5.0], [4.0], [3.0], [3.0 - 1e-6], [1.0]])
    first, second = planning._choices(returns, 3, planning.TIE)
    assert first[0].tolist() == [0, 1, 2] and second[0].tolist() == [0, 1, 3]
    assert len(planning._choices(returns, 3, 0.0)) == 1
    assert len(planning._choices(returns, 2, planning.TIE)) == 1  # 4 vs 3: no tie
    equal = torch.tensor([[5.0], [3.0], [3.0], [1.0]])
    assert len(planning._choices(equal, 2, 0.0)) == 1  # tie=0 never branches
    assert len(planning._choices(equal, 2, planning.TIE)) == 2


def test_ties_give_more_outcomes_only_where_they_are():
    cfg = tiny("cheetah_cem_3x500")
    traffic = {"solver": "CEM", "solver_kwargs": {"population": 30, "num_elite": 4,
                                                   "max_iterations": 2, "alpha": 0.25},
               "planning_horizon": 4}
    m = model_of(cfg)
    obs = torch.zeros((1, 17))
    state = torch.Generator().manual_seed(4).get_state()
    mean, var = torch.zeros((1, 4, 6)), torch.full((1, 4, 6), 0.25)
    plain = planning.plan_step(m, cfg, traffic, obs, mean, var, state, state, tie=0.0)
    every = planning.plan_step(m, cfg, traffic, obs, mean, var, state, state, tie=1.0)
    assert len(plain) == 1 and len(every) > 1
    assert torch.equal(every[0][0], plain[0][0])


def test_a_crowded_boundary_offers_every_near_swap():
    # The third and fifth best trade places while the fourth stays: rounding can keep any of
    # the three crowded at the boundary.
    returns = torch.tensor([[5.0], [4.0], [3.00002], [3.00001], [3.0], [1.0]],
                           dtype=torch.float64)
    sets = [s[0].tolist() for s in planning._choices(returns, 3, planning.TIE)]
    assert sets[0] == [0, 1, 2]
    assert sorted(sets) == [[0, 1, 2], [0, 1, 3], [0, 1, 4]]
    gaps = [g for g, _ in planning._alternatives(returns, 3, planning.TIE)]
    assert gaps == sorted(gaps) and gaps[0] == 0.0


def test_the_search_stops_at_the_outcome_it_is_asked_for():
    cfg = tiny("cheetah_cem_3x500")
    traffic = {"solver": "CEM", "solver_kwargs": {"population": 30, "num_elite": 4,
                                                   "max_iterations": 3, "alpha": 0.25},
               "planning_horizon": 4}
    m = model_of(cfg)
    obs = torch.zeros((1, 17))
    state = torch.Generator().manual_seed(4).get_state()
    mean, var = torch.zeros((1, 4, 6)), torch.full((1, 4, 6), 0.25)
    every = planning.plan_step(m, cfg, traffic, obs, mean, var, state, state, tie=1.0)
    target = every[len(every) // 2][1]
    found = planning.plan_step(m, cfg, traffic, obs, mean, var, state, state, tie=1.0,
                               accept=lambda action, final: torch.equal(final, target))
    assert torch.equal(found[-1][1], target) and len(found) == len(every) // 2 + 1
