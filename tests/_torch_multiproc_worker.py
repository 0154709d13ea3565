"""Worker of the port's two-rank ``gloo`` worlds on the CPU (the port's counterpart of
``tests/_multiproc_worker.py``).

The module fixtures of ``tests/test_torch_parallel.py`` and ``tests/test_torch_fused_sharded.py``
start it once per rank::

    python tests/_torch_multiproc_worker.py <rank> <world> <store> <inputs.pkl> <out.pkl> <suite>

Each rank joins the world through the file ``<store>`` (a ``FileStore``: no port to collide
with under pytest-xdist), runs every scenario of ``<suite>`` on the same inputs with one
intra-op thread and writes its results. The tests compare both ranks with each other, with
the unsharded port (the same scenario functions called with ``mesh=None``) and with the JAX
package. The worker imports the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.learning import DynamicsHandler, make_trainer
from blackbox_mpc_torch.learning.trainer import flat_params
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.ops import fused_sharded as fs
from blackbox_mpc_torch.parallel import (
    fetch_replicated,
    initialize_multihost,
    is_multihost,
    local_agent_slice,
    make_pop_mesh,
    make_sharded_evaluator,
    replicate_to_global,
)
from blackbox_mpc_torch.policies import MPCPolicy
from blackbox_mpc_torch.rollout import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import make_solver
from blackbox_mpc_torch.solvers.cem import CEMConfig
from blackbox_mpc_torch.solvers.cma_es import CMAESConfig
from blackbox_mpc_torch.solvers.pi2 import MPPIConfig, PI2Config
from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig

# ------------------------------------------------------------------ shared settings

PENDULUM_BOUNDS = (-2.0, 2.0)
PENDULUM_OBS = [[-1.0, 0.0, 0.0], [0.5, 0.5, 1.0]]
# tests/test_parallel.py's eight solvers and their settings.
SOLVERS = ("CEM", "PI2", "RandomSearch", "SPSA", "PSO", "CMA-ES", "Gradient", "CEM-GD")
AGENT_SOLVE = dict(planning_horizon=8, num_agents=8, population=32, max_iterations=2,
                   num_elite=4)
# The fused solves, by label: (factory name, config class, config kwargs).
FUSED_H, FUSED_A = 5, 2
FUSED = {
    "CEM": ("make_sharded_fused_cem", CEMConfig, dict(num_elite=4, max_iterations=2)),
    "CEM colored": ("make_sharded_fused_cem", CEMConfig,
                    dict(num_elite=4, max_iterations=2, colored_noise_beta=2.0)),
    "CEM decay": ("make_sharded_fused_cem", CEMConfig,
                  dict(num_elite=4, max_iterations=3, population_decay=0.6)),
    "CEM ts1": ("make_sharded_fused_cem", CEMConfig, dict(num_elite=4, max_iterations=2)),
    "PI2": ("make_sharded_fused_pi2", PI2Config,
            dict(max_iterations=2, adapt_variance=True, lamda=0.5)),
    "MPPI": ("make_sharded_fused_pi2", MPPIConfig, dict(max_iterations=2, lamda=0.5)),
    "RandomSearch": ("make_sharded_fused_random_search", RandomSearchConfig, dict()),
    "sep-CMA-ES": ("make_sharded_fused_sep_cma", CMAESConfig,
                   dict(num_elite=8, max_iterations=2, diagonal=True)),
}
FUSED_POPULATION, FUSED_TILE = 32, 8


def eval_reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(a * a, dim=-1)


def fused_reward(s, a, ns):
    return -torch.sum(torch.square(ns), dim=-1) - 0.01 * torch.sum(torch.square(a), dim=-1)


def numpy_tree(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    return x


def learned(case: dict):
    """``(config, dynamics_params)`` of an input case: a config's fields and JAX's weights."""
    config = tdyn.LearnedDynamicsConfig(**case["config"])
    dp = dynamics_params_from_numpy(case["params"], case["stats"], config, device="cpu")
    return config, dp


@contextlib.contextmanager
def patched_seed(seed: int):
    """Every fused iteration draws ``seed`` (JAX's side patches ``jax.random.randint``)."""
    real = fc.draw_seed
    fc.draw_seed = lambda generator: torch.tensor([seed], dtype=torch.int32)
    try:
        yield
    finally:
        fc.draw_seed = real


# ------------------------------------------------------------------ suite "parallel"


def evaluator(mesh, inp) -> dict:
    """The (sharded) evaluator over each learned case's candidates and noise."""
    out = {}
    for label, case in inp["evaluator"].items():
        config, dp = learned(case)
        fn = tdyn.make_learned_dynamics(config)[1]
        step = lambda s, a, n=None, dp=dp, fn=fn: fn(dp, s, a, n)  # noqa: E731
        options = dict(num_particles=case.get("particles", 1))
        if mesh is None:
            evaluate = make_trajectory_evaluator(step, eval_reward, device="cpu", **options)
        else:
            evaluate = make_sharded_evaluator(step, eval_reward, mesh,
                                              shard_axis=case.get("shard_axis", "population"),
                                              **options)
        noise = case.get("noise")
        out[label] = evaluate(torch.as_tensor(case["s0"]), torch.as_tensor(case["acts"]),
                              None if noise is None else torch.as_tensor(noise)).numpy()
    return out


def pendulum_solve(mesh, name: str, shard_axis: str = "population", **kwargs) -> tuple:
    """One solve of ``name`` on the analytic pendulum: ``(action, expected_reward)``."""
    if mesh is None:
        evaluate = make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device="cpu")
    else:
        evaluate = make_sharded_evaluator(pendulum_dynamics, pendulum_reward, mesh,
                                          shard_axis=shard_axis)
    solver = make_solver(name, Bounds.of(*PENDULUM_BOUNDS, dim=1), evaluate, **kwargs)
    agents = kwargs["num_agents"]
    obs = torch.tensor(PENDULUM_OBS * (agents // 2))
    state = solver.init(torch.Generator().manual_seed(0))
    action, _, aux = solver.solve(state, obs, 0, torch.Generator().manual_seed(3))
    return action.detach().numpy(), aux.expected_reward.detach().numpy()


def solver_kwargs(name: str) -> dict:
    """tests/test_parallel.py's settings of each solver."""
    if name == "RandomSearch":
        return dict(planning_horizon=10, num_agents=2, population=64)
    kwargs = dict(planning_horizon=10, num_agents=2, population=64, max_iterations=2)
    if name in ("CEM", "CEM-GD", "CMA-ES"):
        kwargs["num_elite"] = 8
    if name == "CEM-GD":
        kwargs.update(gd_candidates=4, gd_iterations=3)
    return kwargs


def solvers(mesh, inp) -> dict:
    out = {name: pendulum_solve(mesh, name, **solver_kwargs(name)) for name in SOLVERS}
    out["CEM agents"] = pendulum_solve(mesh, "CEM", "agents", **AGENT_SOLVE)
    return out


def swing_up(mesh, inp) -> np.ndarray:
    """tests/test_parallel.py's sharded policy: 80 steps from hanging; the final state."""
    policy = MPCPolicy(BoxSpace.of(*PENDULUM_BOUNDS, dim=1), pendulum_reward,
                       DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                       "CEM", num_agents=1, planning_horizon=25, population=256,
                       num_elite=25, max_iterations=5, mesh=mesh, device="cpu")
    obs = np.array([-1.0, 0.0, 0.0], np.float32)
    for t in range(80):
        action, _, _ = policy.act(obs, t)
        obs = pendulum_dynamics(torch.as_tensor(obs[None]), torch.as_tensor(action[None]))[0]
        obs = obs.numpy()
    return obs


def training(mesh, inp) -> dict:
    """Three (data-parallel) Adam steps per case: ``(losses [3, E], params)``."""
    out = {}
    for label, case in inp["training"].items():
        config, dp = learned(case)
        init, step, _ = make_trainer(config, mesh=mesh)
        ts = init(dp.params)
        losses = [step(ts, dp.stats, *(torch.as_tensor(x) for x in case["batch"]))[1]
                  for _ in range(3)]
        out[label] = (torch.stack(losses).numpy(), numpy_tree(flat_params(ts.params)))
    return out


def handler(mesh, inp) -> dict:
    """``DynamicsHandler.train`` twice: each call's info and the planning weights."""
    case = inp["handler"]
    h = DynamicsHandler(tdyn.LearnedDynamicsConfig(**case["config"]), device="cpu", seed=0,
                        mesh=mesh)
    infos = [h.train(case["obs"][i::2], case["acts"][i::2], epochs=2, batch_size=32)
             for i in range(2)]
    return {"infos": infos, "params": numpy_tree(flat_params(h.dynamics_params.params))}


def artifact(mesh, inp) -> dict:
    """Each shard axis: an eager CEM policy on the pendulum acts once, exports this rank's
    artifact and goes on beside the ``ServingPolicy`` loaded from it: a greedy, a noisy and a
    post-reset ``act()`` of each (``{"axis": (meta, live actions, served actions)}``).

    ``"compiled"``, on the population axis: this rank's programs compiled with AOTInductor
    (collectives included) by an instance that saves this rank's cache, and an instance loaded
    from that cache; the same three ``act()``s of each, whether the cache was used, and the
    cache's fingerprint."""
    from blackbox_mpc_torch.deploy import ServingPolicy, export_policy_artifact

    out = {}
    obs = np.array(PENDULUM_OBS * 2, np.float32)
    for axis in ("population", "agents"):
        live = MPCPolicy(BoxSpace.of(*PENDULUM_BOUNDS, dim=1), pendulum_reward,
                         DynamicsHandler(true_model=pendulum_dynamics, device="cpu"), "CEM",
                         num_agents=4, planning_horizon=8, population=32, num_elite=4,
                         max_iterations=2, seed=5, mesh=mesh, shard_axis=axis, device="cpu")
        live.act(obs, 0)
        path = f"{inp['artifact_dir']}/{axis}.rank{mesh.rank}.bbmpc"
        meta = export_policy_artifact(live, path, dim_s=3)
        policies = [live, ServingPolicy.load(path, device="cpu")]
        if axis == "population":
            cache = f"{inp['artifact_dir']}/{axis}.rank{mesh.rank}.cache"
            saver = ServingPolicy.load(path, device="cpu")
            saver.save_compiled(cache)
            policies += [saver, ServingPolicy.load(path, device="cpu", compiled_cache=cache)]
        acts = []
        for policy in policies:
            steps = [policy.act(obs, 1)[0], policy.act(obs, 2, exploration_noise=True)[0]]
            policy.reset()
            acts.append(np.stack(steps + [policy.act(obs, 3)[0]]))
        out[axis] = (dict(policies[1].meta), *acts[:2])
        if axis == "population":
            out["compiled"] = {"saver": acts[2], "cached": acts[3],
                               "used": policies[3].used_compiled_cache,
                               "fingerprint": policies[3]._fingerprint()}
    return out


def multihost(mesh, inp) -> dict:
    return {"slice": local_agent_slice(5), "multihost": is_multihost(),
            "replicated": fetch_replicated(replicate_to_global(np.arange(3.0), mesh))}


# ------------------------------------------------------------------ suite "fused"


def fused_kernels(mesh, inp) -> dict:
    """The sharded kernel pair at one seed: ``rewards [P, A]`` (MPPI: also the dots), this
    rank's own rewards, and the moments of the given weights, for each option set."""
    case = inp["fused"]
    config, dp = learned(case["model"])
    s0, mean, std = (torch.as_tensor(case[k]) for k in ("s0", "mean", "std"))
    weights = torch.as_tensor(case["weights"])
    seed = case["seed"]
    out = {}
    for label, options in inp["kernel_options"].items():
        options = dict(options)
        if "clip_bounds" in options:
            options["clip_bounds"] = tuple(np.asarray(b, np.float32)
                                           for b in options["clip_bounds"])
        aux = options.get("aux_dot", False)
        rollout, moments = fs._sharded_pair(fc.make_fused_cem_kernels(
            config, fused_reward, horizon=FUSED_H, agents=FUSED_A,
            population=FUSED_POPULATION // mesh.size, tile=FUSED_TILE, **options), mesh, aux)
        gvec = torch.as_tensor(case["gvec"]) if aux else None
        rewards = rollout(dp, s0, mean, std, seed, gvec=gvec)
        local = rollout.local(dp, s0, mean, std, fs.device_seed(torch.tensor([seed]),
                                                                  mesh.rank), gvec=gvec)
        out[label] = {"rewards": numpy_tree(rewards), "local": numpy_tree(local),
                      "moments": numpy_tree(moments(mean, std, seed, weights))}
    return out


def fused_solves(mesh, inp) -> dict:
    """Each sharded fused solver's solve at the patched seed."""
    bounds = Bounds.of(-1.0, 1.0, dim=2)
    obs = torch.as_tensor(inp["fused"]["obs"])
    out = {}
    with patched_seed(inp["fused"]["seed"]):
        for label, (factory, config_cls, kwargs) in FUSED.items():
            config, dp = learned(inp["fused"]["model ts1" if label == "CEM ts1" else "model"])
            solver = getattr(fs, factory)(
                config_cls(planning_horizon=FUSED_H, num_agents=FUSED_A,
                           population=FUSED_POPULATION, **kwargs),
                bounds, config, dp, fused_reward, mesh, tile=FUSED_TILE)
            action, state, aux = solver.solve(solver.init(torch.Generator()), obs, 0,
                                               torch.Generator())
            out[label] = {"name": solver.name, "action": action.numpy(),
                          "plan": aux.plan.numpy(),
                          "expected_reward": aux.expected_reward.numpy(),
                          "mean": None if not hasattr(state, "mean") else state.mean.numpy()}
    return out


def fused_policy(mesh, inp) -> dict:
    """``MPCPolicy(rollout_backend="fused", mesh=...)``: its plan at the patched seed, then two
    ``act()``s at the policy's own seeds."""
    config, dp = learned(inp["fused"]["model"])
    h = DynamicsHandler(config, device="cpu")
    h.set_params(dp)
    policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=2), fused_reward, h,
                       rollout_backend="fused", mesh=mesh, device="cpu", planning_horizon=5,
                       population=48, num_elite=6, max_iterations=2)
    obs = inp["fused"]["obs"][0]
    with patched_seed(inp["fused"]["seed"]):
        plan, expected = policy.plan(obs)
    actions = [policy.act(obs, t)[0] for t in range(2)]
    return {"name": policy._solver.name, "plan": plan, "expected": expected,
            "actions": np.stack(actions)}


def card_fused(mesh, inp) -> dict:
    """Fused CEM and RandomSearch over ranks that share one card: two ``act()``s each and
    every kernel's launches over them."""
    config, dp = learned(inp["model"])
    h = DynamicsHandler(config, device=mesh.device)
    h.set_params(dp)
    out = {}
    for name in ("CEM", "RandomSearch"):
        policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=config.dim_u), fused_reward, h, name,
                           rollout_backend="fused", mesh=mesh, planning_horizon=10,
                           population=96, max_iterations=3, seed=1,
                           **({"num_elite": 8} if name == "CEM" else {}))
        counters = {k: getattr(fc, k) for k in ("fused_rollout", "elite_moments", "draw_rows")}
        for c in counters.values():
            c.launches = 0
        obs = np.zeros(config.dim_s, np.float32)
        actions = [policy.act(obs, t)[0] for t in range(2)]
        out[name] = {"actions": np.stack(actions),
                     "launches": {k: c.launches for k, c in counters.items()}}
    return out


SUITES = {
    "parallel": (evaluator, solvers, swing_up, training, handler, artifact, multihost),
    "fused": (fused_kernels, fused_solves, fused_policy),
    "card": (card_fused,),
}


def run_world(suite: str, inputs: dict, workdir: Path, world: int = 2,
              timeout: float = 300.0) -> list:
    """Runs ``suite`` on ``inputs`` in a world of ``world`` ranks, one process each; returns
    each rank's results."""
    repo = Path(__file__).resolve().parents[1]
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    outs = [workdir / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world),
         str(workdir / "store"), str(workdir / "inputs.pkl"), str(outs[r]), suite],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append((p.returncode,) + p.communicate(timeout=timeout)[::-1])
    finally:
        for p in procs:
            p.kill()
    for (_, err, _), p in zip(logs, procs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{err[-4000:]}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def main() -> None:
    rank, world, store, inputs, out, suite = sys.argv[1:7]
    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    device = inp.get("device", "cpu")  # ranks on one card share it over gloo
    initialize_multihost(f"file://{store}", int(world), int(rank), device=device,
                         backend="gloo")
    mesh = make_pop_mesh(device=device)
    results = {fn.__name__: fn(mesh, inp) for fn in SUITES[suite]}
    with open(out, "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
