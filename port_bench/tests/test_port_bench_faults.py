"""The timed path broken underneath: each fault that a cell can have makes ``correct`` come
out false on the dry path (a step that leaves its state unchanged; half of the batch left
out; an answer altered where it is produced). One card: no exchange between chips to
leave out."""
import pytest
import torch

from port_bench.tests.tiny import dry_run

PLANNING = ["cheetah_cem_3x500.cem_closed_loop", "pets_halfcheetah.ts_inf_closed_loop",
            "cheetah_cem_3x500.random_search"]
WARM = PLANNING[:2]  # the cells whose solver carries a state


def correct(out) -> bool:
    return out.failed == 0 and all(c.ok for c in out.checks.values())


def failing(out) -> list:
    return sorted(k for k, c in out.checks.items() if not c.ok)


@pytest.fixture
def policy_module():
    from blackbox_mpc_torch.policies import mpc_policy

    return mpc_policy


@pytest.mark.parametrize("workload", PLANNING)
def test_sound(workload):
    assert correct(dry_run(workload)[1])


@pytest.mark.parametrize("workload", WARM)
def test_state_left_unchanged(workload, policy_module, monkeypatch):
    solve = policy_module.MPCPolicy._solve

    def unchanged(self, state, *args, **kwargs):
        action, _, aux = solve(self, state, *args, **kwargs)
        return action, state, aux

    monkeypatch.setattr(policy_module.MPCPolicy, "_solve", unchanged)
    out = dry_run(workload)[1]
    assert not correct(out) and "answer" in failing(out)


@pytest.mark.parametrize("workload", PLANNING)
def test_half_the_candidates_left_out(workload, policy_module, monkeypatch):
    make = policy_module.MPCPolicy._make_evaluate

    def halved(self, *args, **kwargs):
        evaluate = make(self, *args, **kwargs)

        def left_out(obs, actions):
            returns = evaluate(obs, actions).clone()
            returns[returns.shape[0] // 2:] = -1e6
            return returns

        return left_out

    monkeypatch.setattr(policy_module.MPCPolicy, "_make_evaluate", halved)
    out = dry_run(workload)[1]
    assert not correct(out) and "answer" in failing(out)


@pytest.mark.parametrize("workload", PLANNING)
def test_action_altered(workload, policy_module, monkeypatch):
    solve = policy_module.MPCPolicy._solve

    def altered(self, *args, **kwargs):
        action, state, aux = solve(self, *args, **kwargs)
        return torch.clamp(action + 0.01, -1.0, 1.0), state, aux

    monkeypatch.setattr(policy_module.MPCPolicy, "_solve", altered)
    out = dry_run(workload)[1]
    assert not correct(out) and "answer" in failing(out)


@pytest.fixture
def trainer_of(monkeypatch):
    """Replaces the handler's trainer by ``wrap(train_step)``."""
    from blackbox_mpc_torch.learning import handler

    def install(wrap):
        make = handler.make_trainer

        def make_trainer(*args, **kwargs):
            init, step, evaluate = make(*args, **kwargs)
            return init, wrap(step), evaluate

        monkeypatch.setattr(handler, "make_trainer", make_trainer)

    return install


def test_training_sound():
    assert correct(dry_run("pets_halfcheetah.train")[1])


def test_training_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = dry_run("pets_halfcheetah.train")[1]
    assert not correct(out) and "update" in failing(out)


def test_training_half_batch(trainer_of):
    def wrap(step):
        def half(ts, stats, s, a, ns):
            cut = s.shape[1] // 2
            return step(ts, stats, s[:, :cut], a[:, :cut], ns[:, :cut])
        return half

    trainer_of(wrap)
    out = dry_run("pets_halfcheetah.train")[1]
    assert not correct(out) and "loss" in failing(out)


def test_training_loss_altered(trainer_of):
    def wrap(step):
        def altered(*args):
            ts, losses = step(*args)
            return ts, losses * 1.01
        return altered

    trainer_of(wrap)
    out = dry_run("pets_halfcheetah.train")[1]
    assert not correct(out) and "loss" in failing(out)
