"""Tutorial: export an MPC policy to a standalone serving artifact, serve it, and compile it.

Torch twin of ``tutorials/deploy/tutorial_one.py``. The whole policy step becomes one
``.bbmpc`` file (``torch.export`` programs), and ``ServingPolicy``, a self-contained loader,
drives the control loop with no package code, bit for bit as the live policy. The twin adds
the compiled cache: ``save_compiled`` compiles the artifact's programs for this device with
AOTInductor and writes them to a file, and ``ServingPolicy.load(compiled_cache=)`` serves
from it with no compile at start.
"""
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from _common import setup

args = setup("Deploy: export + serve", steps=60)

import numpy as np

from blackbox_mpc_torch import (
    DynamicsHandler,
    MPCPolicy,
    ServingPolicy,
    export_policy_artifact,
    perform_rollouts,
)
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.models import pendulum_dynamics, pendulum_reward

env = NativePendulumVecEnv(num_envs=1, seed=args.seed)
policy = MPCPolicy(
    action_space=env.action_space, reward_function=pendulum_reward,
    dynamics_handler=DynamicsHandler(true_model=pendulum_dynamics, device=args.device),
    solver_name="CEM", planning_horizon=20, population=256, num_elite=25,
    max_iterations=5, seed=args.seed, device=args.device,
)

workdir = pathlib.Path(tempfile.mkdtemp(prefix="bbmpc_deploy_"))
artifact = str(workdir / "controller.bbmpc")
meta = export_policy_artifact(policy, artifact, dim_s=3)
size_kb = pathlib.Path(artifact).stat().st_size // 1024
print(f"exported {meta['solver_name']} controller -> {artifact} ({size_kb} KB, "
      f"platforms={meta['platforms']})")

# Serve it: the artifact alone drives the env (in production, copy deploy/serving.py and
# the .bbmpc file into the container; nothing else is needed).
serving = ServingPolicy.load(artifact, device=args.device)
result = perform_rollouts(env, serving, number_of_rollouts=1, rollout_horizon=args.steps)
print(f"served-artifact episode reward: {result['reward_sum'][0]:.1f}")

# The served controller is bit-identical to the live one from the export point.
obs = np.array([1.0, 0.0, 0.0], np.float32)
live_action, _, _ = policy.act(obs)
srv2 = ServingPolicy.load(artifact, device=args.device)
served_action, _, _ = srv2.act(obs)
assert np.array_equal(live_action, served_action), "serving must bit-match the live policy"
print(f"bitwise match vs live policy: action={served_action}")

# The compiled cache: compile once, then every server start loads the compiled programs.
cache = str(workdir / "controller.cache")
t0 = time.perf_counter()
ServingPolicy.load(artifact, device=args.device).save_compiled(cache)
compile_s = time.perf_counter() - t0
t0 = time.perf_counter()
compiled = ServingPolicy.load(artifact, device=args.device, compiled_cache=cache)
load_s = time.perf_counter() - t0
assert compiled.used_compiled_cache, "the compiled cache was not used"
compiled_action, _, _ = compiled.act(obs)
print(f"compiled cache: {pathlib.Path(cache).stat().st_size // 1024} KB, compiled in "
      f"{compile_s:.1f} s, loaded in {load_s:.2f} s, used_compiled_cache="
      f"{compiled.used_compiled_cache}, action={compiled_action} (uncompiled "
      f"{served_action}, max |diff| {float(np.abs(compiled_action - served_action).max()):.2e})")
env.close()
