"""Vectorized gymnasium environments: in-process, threaded and subprocess backends.

A copy of ``blackbox_mpc_torch/envs/vec_env.py`` (numpy only):

* three interchangeable backends: ``sync`` (one process, a Python loop; for cheap envs),
  ``thread`` (a thread pool; for envs that release the GIL) and ``subprocess`` (one worker
  process per env over pipes; for CPU-heavy envs);
* a split ``step_async()`` / ``step_wait()`` API, so host-side env stepping can overlap the
  next device solve;
* a crashed worker raises instead of hanging the parent on ``recv()``.

``gymnasium`` is imported only inside :func:`make_gym_vec_env`: the port runs without it.
"""
from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from blackbox_mpc_torch.core.spaces import as_box_space

__all__ = ["GymVecEnv", "make_gym_vec_env", "make_custom_vec_env"]


def _env_worker(pipe, env_fn, seed: int):
    """Worker loop: strict request/reply over one pipe (cmd, payload)."""
    try:
        env = env_fn()
        pipe.send(("ready", (as_box_space(env.action_space), as_box_space(env.observation_space))))
    except Exception as e:  # noqa: BLE001
        pipe.send(("error", repr(e)))
        return
    while True:
        try:
            cmd, payload = pipe.recv()
            if cmd == "step":
                obs, rew, terminated, truncated, info = env.step(payload)
                pipe.send(("ok", (obs, rew, terminated or truncated, info)))
            elif cmd == "reset":
                obs, _info = env.reset(seed=payload)
                pipe.send(("ok", obs))
            elif cmd == "render":
                pipe.send(("ok", env.render()))
            elif cmd == "close":
                env.close()
                pipe.send(("ok", None))
                return
            else:
                pipe.send(("error", f"unknown command {cmd!r}"))
        except EOFError:
            return
        except Exception as e:  # noqa: BLE001
            pipe.send(("error", repr(e)))


class GymVecEnv:
    """N gymnasium environments behind one batched (obs, reward, done) interface."""

    def __init__(
        self,
        env_fns: Sequence[Callable],
        mode: str = "sync",
        base_seed: int = 0,
        restart_on_crash: bool = False,
    ):
        """``restart_on_crash``: in subprocess mode, a dead worker is respawned (and its env
        reset) instead of raising."""
        if mode not in ("sync", "thread", "subprocess"):
            raise ValueError(f"mode must be sync|thread|subprocess, got {mode!r}")
        self.num_envs = len(env_fns)
        self._mode = mode
        self._base_seed = base_seed
        self._pending = False
        self._restart_on_crash = restart_on_crash
        self._env_fns = list(env_fns)
        if mode == "subprocess":
            self._ctx = mp.get_context("fork")
            self._pipes, self._procs = [None] * self.num_envs, [None] * self.num_envs
            for rank in range(self.num_envs):
                self._spawn_worker(rank)
            spaces = [self._recv(i) for i in range(self.num_envs)]
            self.action_space, self.observation_space = spaces[0]
        else:
            self._envs = [fn() for fn in env_fns]
            self.action_space = as_box_space(self._envs[0].action_space)
            self.observation_space = as_box_space(self._envs[0].observation_space)
            self._pool = (
                ThreadPoolExecutor(max_workers=self.num_envs) if mode == "thread" else None
            )

    # ------------------------------------------------------------------ subprocess plumbing

    def _spawn_worker(self, rank: int) -> None:
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_env_worker,
            args=(child, self._env_fns[rank], self._base_seed + rank),
            daemon=True,
        )
        p.start()
        child.close()
        self._pipes[rank] = parent
        self._procs[rank] = p

    def _restart_worker(self, rank: int):
        """Respawns a crashed worker, resets its env, and returns the fresh observation."""
        import logging

        logging.getLogger(__name__).warning("restarting crashed env worker %d", rank)
        try:
            self._procs[rank].terminate()
        except Exception:  # noqa: BLE001
            pass
        self._spawn_worker(rank)
        self._recv(rank, allow_restart=False)  # ready handshake
        self._pipes[rank].send(("reset", self._base_seed + rank))
        return self._recv(rank, allow_restart=False)

    def _recv(self, i: int, allow_restart: bool = False):
        """``allow_restart`` is only passed by the step path: the restart recovery returns a
        step-shaped (obs, reward, done, info) tuple, which reset()/handshake must not see."""
        try:
            status, payload = self._pipes[i].recv()
        except (EOFError, ConnectionResetError) as e:
            if self._restart_on_crash and allow_restart:
                obs = self._restart_worker(i)
                # Report the respawned env's reset observation as a terminal transition.
                return (obs, 0.0, True, {"worker_restarted": True})
            raise RuntimeError(f"env worker {i} died: {e!r}") from None
        if status == "error":
            raise RuntimeError(f"env worker {i} failed: {payload}")
        return payload

    # ------------------------------------------------------------------ API

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        base = self._base_seed if seed is None else seed
        if self._mode == "subprocess":
            for rank, pipe in enumerate(self._pipes):
                pipe.send(("reset", base + rank))
            obs = [self._recv(i) for i in range(self.num_envs)]
        else:
            obs = [env.reset(seed=base + rank)[0] for rank, env in enumerate(self._envs)]
        return np.stack(obs).astype(np.float32)

    def step(self, actions: np.ndarray):
        self.step_async(actions)
        return self.step_wait()

    def step_async(self, actions: np.ndarray) -> None:
        """Dispatches a step without blocking — overlap env stepping with device compute."""
        if self._pending:
            raise RuntimeError("step_async called with a step already pending")
        actions = np.asarray(actions)
        if self._mode == "subprocess":
            for rank, pipe in enumerate(self._pipes):
                pipe.send(("step", actions[rank]))
        elif self._mode == "thread":
            self._futures = [
                self._pool.submit(env.step, actions[rank])
                for rank, env in enumerate(self._envs)
            ]
        else:
            self._sync_actions = actions
        self._pending = True

    def step_wait(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        if not self._pending:
            raise RuntimeError("step_wait called without step_async")
        self._pending = False
        if self._mode == "subprocess":
            results = [self._recv(i, allow_restart=True) for i in range(self.num_envs)]
            obs, rew, done, infos = zip(*results)
        elif self._mode == "thread":
            out = [f.result() for f in self._futures]
            obs = [o[0] for o in out]
            rew = [o[1] for o in out]
            done = [o[2] or o[3] for o in out]
            infos = [o[4] for o in out]
        else:
            out = [env.step(self._sync_actions[rank]) for rank, env in enumerate(self._envs)]
            obs = [o[0] for o in out]
            rew = [o[1] for o in out]
            done = [o[2] or o[3] for o in out]
            infos = [o[4] for o in out]
        return (
            np.stack(obs).astype(np.float32),
            np.asarray(rew, np.float32),
            np.asarray(done, bool),
            list(infos),
        )

    def render(self):
        if self._mode == "subprocess":
            self._pipes[0].send(("render", None))
            return self._recv(0)
        return self._envs[0].render()

    def close(self) -> None:
        if self._mode == "subprocess":
            for pipe in self._pipes:
                try:
                    pipe.send(("close", None))
                except (BrokenPipeError, OSError):
                    pass
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
        else:
            if self._pool is not None:
                self._pool.shutdown()
            for env in self._envs:
                env.close()


def make_gym_vec_env(
    env_id: str,
    num_envs: int = 1,
    mode: str = "sync",
    base_seed: int = 0,
    render_mode: Optional[str] = None,
    restart_on_crash: bool = False,
    **env_kwargs,
) -> GymVecEnv:
    """Builds N seeded copies of a gymnasium env (counterpart of
    ``EnvironmentWrapper.make_standard_gym_env``, environment_wrapper.py:8-40)."""

    def env_fn():
        import gymnasium

        return gymnasium.make(env_id, render_mode=render_mode, **env_kwargs)

    return GymVecEnv(
        [env_fn] * num_envs, mode=mode, base_seed=base_seed, restart_on_crash=restart_on_crash
    )


def make_custom_vec_env(
    env_fn: Callable,
    num_envs: int = 1,
    mode: str = "sync",
    base_seed: int = 0,
    restart_on_crash: bool = False,
) -> GymVecEnv:
    """N copies of a user-constructed env (counterpart of
    ``EnvironmentWrapper.make_custom_gym_env``, environment_wrapper.py:43-76)."""
    return GymVecEnv(
        [env_fn] * num_envs, mode=mode, base_seed=base_seed, restart_on_crash=restart_on_crash
    )
