"""``state.replace(**changes)`` on the eight solver states of the port, as on the JAX package's
flax struct states: a copy of the same type with the given fields changed and every other field
the same object, the original untouched, an unknown field refused; the fields are the JAX
state's. A low-level caller warm-starts a plan this way, and the solve takes the copy.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from blackbox_mpc_tpu.core import Bounds as JBounds
from blackbox_mpc_tpu.models import pendulum_dynamics as j_pendulum_dynamics
from blackbox_mpc_tpu.models import pendulum_reward as j_pendulum_reward
from blackbox_mpc_tpu.rollout import make_trajectory_evaluator as j_make_trajectory_evaluator
from blackbox_mpc_tpu.solvers import make_solver as j_make_solver
from blackbox_mpc_torch import Bounds, make_solver, make_trajectory_evaluator
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward

torch.set_num_threads(1)

BASE = dict(planning_horizon=4, population=8, max_iterations=1)
SOLVERS = {
    "CEM": dict(num_elite=2),
    "CEM-GD": dict(num_elite=4, gd_candidates=2, gd_iterations=1),
    "CMA-ES": dict(num_elite=2),
    "Gradient": dict(population=2),
    "PI2": {},
    "PSO": {},
    "RandomSearch": {},
    "SPSA": {},
}
OBS = [[-1.0, 0.0, 0.0]]


def states(name):
    """(the port's solver, its initial state, JAX's initial state) for ``name``."""
    kw = {**BASE, **SOLVERS[name]}
    solver = make_solver(name, Bounds.of(-2.0, 2.0, dim=1),
                         make_trajectory_evaluator(pendulum_dynamics, pendulum_reward,
                                                   device="cpu"), **kw)
    j_solver = j_make_solver(name, JBounds.of(-2.0, 2.0, dim=1),
                             j_make_trajectory_evaluator(j_pendulum_dynamics, j_pendulum_reward),
                             **kw)
    return solver, solver.init(torch.Generator().manual_seed(0)), j_solver.init(
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_replace_changes_only_the_given_fields(name):
    solver, state, j_state = states(name)
    names = [f.name for f in dataclasses.fields(state)]
    assert names == [f.name for f in dataclasses.fields(j_state)]
    with pytest.raises(TypeError):
        j_state.replace(not_a_field=0)
    with pytest.raises(TypeError):
        state.replace(not_a_field=0)
    copy = state.replace()
    assert type(copy) is type(state) and copy is not state
    if not names:  # RandomSearch carries no state
        return
    first = names[0]
    before = getattr(state, first)
    new = torch.full_like(before, 0.25)
    changed = state.replace(**{first: new})
    j_changed = j_state.replace(**{first: jax.numpy.full_like(getattr(j_state, first), 0.25)})
    assert type(changed) is type(state)
    assert getattr(changed, first) is new and getattr(state, first) is before
    np.testing.assert_array_equal(getattr(changed, first).numpy(),
                                  np.asarray(getattr(j_changed, first)))
    for other in names[1:]:
        assert getattr(changed, other) is getattr(state, other)
    # The solve takes the warm-started copy and returns a state of the same type.
    action, next_state, _ = solver.solve(changed, torch.tensor(OBS), torch.tensor(0),
                                         torch.Generator().manual_seed(1))
    assert type(next_state) is type(state) and torch.isfinite(action).all()
