"""Shared-memory vectorized environment: native IPC without pickling.

A copy of ``blackbox_mpc_torch/envs/shm_vec_env.py``. One shared memory region per vec env holds
per-worker slots of raw float32 action/observation buffers and an atomic status word. Per step
the parent writes the actions in place and publishes a REQUEST status, and the C++ primitives
of ``native/shm_sync.cpp`` (``native/libshm_sync.so``, loaded through ctypes from the
repository root and built on demand with ``make -C native``) spin/sleep-wait on both sides.

``step_async``/``step_wait`` are split as in the other backends. The workers still run Python
(they host the gymnasium env); the transport is native.
"""
from __future__ import annotations

import ctypes
import functools
import multiprocessing as mp
import os
import pickle
import subprocess
from multiprocessing import shared_memory
from typing import Callable, Optional, Sequence

import numpy as np

from blackbox_mpc_torch.core.spaces import BoxSpace, as_box_space

__all__ = ["ShmVecEnv", "make_shm_vec_env"]

_STEP, _RESET, _DONE, _ERROR = 1, 2, 100, 101  # worker status protocol
_STATUS_BYTES = 64  # one cache line per status word


def _lib_path() -> str:
    """``native/libshm_sync.so`` at the repository root (three levels above this file)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libshm_sync.so")


def _load_lib() -> ctypes.CDLL:
    path = _lib_path()
    if not os.path.exists(path):
        # Build on demand — g++ is part of the supported toolchain.
        subprocess.run(["make", "-C", os.path.dirname(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    lib.shm_store.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.shm_load.argtypes = [ctypes.c_void_p]
    lib.shm_load.restype = ctypes.c_int32
    lib.shm_wait.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64]
    lib.shm_wait.restype = ctypes.c_int32
    lib.shm_wait_all.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.shm_wait_all.restype = ctypes.c_int32
    return lib


class _Layout:
    """Byte layout of one vec-env region: [n * status cacheline][n * slot payload]."""

    def __init__(self, num_envs: int, dim_s: int, dim_u: int):
        self.num_envs = num_envs
        self.dim_s = dim_s
        self.dim_u = dim_u
        self.status_bytes = _STATUS_BYTES * num_envs
        # payload per slot: action [U] f32, obs [S] f32, reward f32, done f32, seed i32
        # (the seed travels as raw int32 bytes — a float32 slot would silently lose
        # precision above 2^24 and reseed workers with the wrong value)
        self.slot_floats = dim_u + dim_s + 3
        self.slot_bytes = 4 * self.slot_floats
        self.total_bytes = self.status_bytes + num_envs * self.slot_bytes

    def status_offset(self, rank: int) -> int:
        return _STATUS_BYTES * rank

    def slot_view(self, buf, rank: int) -> np.ndarray:
        start = self.status_bytes + rank * self.slot_bytes
        return np.ndarray((self.slot_floats,), dtype=np.float32, buffer=buf,
                          offset=start)

    def seed_view(self, buf, rank: int) -> np.ndarray:
        """int32 view over the last slot word (the seed field)."""
        start = self.status_bytes + rank * self.slot_bytes + 4 * (self.slot_floats - 1)
        return np.ndarray((1,), dtype=np.int32, buffer=buf, offset=start)


def _worker_entry(shm_name, rank, num_envs, dim_s, dim_u, env_fn, seed):
    lib = _load_lib()
    shm = shared_memory.SharedMemory(name=shm_name)
    layout = _Layout(num_envs, dim_s, dim_u)
    status_ptr = ctypes.addressof(
        (ctypes.c_char * 1).from_buffer(shm.buf, layout.status_offset(rank))
    )
    slot = layout.slot_view(shm.buf, rank)
    action = slot[:dim_u]
    obs_out = slot[dim_u:dim_u + dim_s]
    rew_out = slot[dim_u + dim_s:dim_u + dim_s + 1]
    done_out = slot[dim_u + dim_s + 1:dim_u + dim_s + 2]
    seed_in = layout.seed_view(shm.buf, rank)
    env = None
    try:
        try:
            env = env_fn()
        except Exception:  # noqa: BLE001
            lib.shm_store(status_ptr, _ERROR)
            return
        lib.shm_store(status_ptr, _DONE)
        while True:
            # wait returns on STEP or RESET; CLOSE is posted as RESET with negative seed
            cmd = lib.shm_wait(status_ptr, _STEP, _RESET, 0)
            if cmd == _RESET and seed_in[0] < 0:
                break
            try:
                if cmd == _RESET:
                    obs, _info = env.reset(seed=int(seed_in[0]))
                    obs_out[:] = np.asarray(obs, np.float32)
                    rew_out[0] = 0.0
                    done_out[0] = 0.0
                else:
                    obs, rew, terminated, truncated, _info = env.step(action.copy())
                    obs_out[:] = np.asarray(obs, np.float32)
                    rew_out[0] = float(rew)
                    done_out[0] = 1.0 if (terminated or truncated) else 0.0
                lib.shm_store(status_ptr, _DONE)
            except Exception:  # noqa: BLE001
                lib.shm_store(status_ptr, _ERROR)
                break
    finally:
        if env is not None:
            env.close()
        # Release every exported view of the shm buffer (numpy slices + the ctypes
        # from_buffer export) before close(), or shm.close() raises BufferError.
        del slot, action, obs_out, rew_out, done_out, seed_in
        import gc

        gc.collect()
        shm.close()


class ShmVecEnv:
    """Vectorized env over the native shared-memory transport (API matches GymVecEnv)."""

    def __init__(
        self,
        env_fns: Sequence[Callable],
        dim_s: int,
        dim_u: int,
        base_seed: int = 0,
        step_timeout_s: float = 60.0,
        action_space: Optional[BoxSpace] = None,
        observation_space: Optional[BoxSpace] = None,
        start_method: Optional[str] = None,
    ):
        """``start_method``: multiprocessing start method for the workers. Default
        ``"fork"`` — env_fns routinely depend on parent-process state (closures, gymnasium
        ids registered in the parent) that only fork inherits. A forked worker must not touch
        CUDA (the env steps on the host); pass
        ``"forkserver"`` or ``"spawn"`` for a clean-interpreter start when your env_fns are
        picklable AND self-contained (no parent-side registrations)."""
        self.num_envs = len(env_fns)
        if base_seed < 0:
            raise ValueError("base_seed must be non-negative")
        self._base_seed = base_seed
        self._timeout_ns = int(step_timeout_s * 1e9)
        self._lib = _load_lib()
        self._layout = _Layout(self.num_envs, dim_s, dim_u)
        self._shm = shared_memory.SharedMemory(create=True, size=self._layout.total_bytes)
        buf = np.ndarray((self._layout.total_bytes,), np.uint8, buffer=self._shm.buf)
        buf[:] = 0
        self._status_base = ctypes.addressof(
            (ctypes.c_char * 1).from_buffer(self._shm.buf, 0)
        )
        self._slots = [self._layout.slot_view(self._shm.buf, r) for r in range(self.num_envs)]
        self._seeds = [self._layout.seed_view(self._shm.buf, r) for r in range(self.num_envs)]
        self._pending = False
        self._closed = False
        if start_method is None:
            start_method = "fork"
        if start_method != "fork":
            # Non-fork children start from a clean interpreter: env_fns must be picklable.
            # Fail here with a clear message rather than an opaque worker error.
            try:
                pickle.dumps(list(env_fns))
            except Exception as e:  # noqa: BLE001
                raise ValueError(
                    f"start_method={start_method!r} needs picklable env_fns; got {e!r}. "
                    "Use start_method='fork' for closures or parent-registered envs."
                ) from e
        ctx = mp.get_context(start_method)
        self._procs = []
        for rank, fn in enumerate(env_fns):
            p = ctx.Process(
                target=_worker_entry,
                args=(self._shm.name, rank, self.num_envs, dim_s, dim_u, fn,
                      base_seed + rank),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        self._wait_all(_DONE)  # ready handshake
        if action_space is None or observation_space is None:
            # Fallback probe; callers with heavy envs should pass the spaces explicitly.
            probe_env = env_fns[0]()
            action_space = as_box_space(probe_env.action_space)
            observation_space = as_box_space(probe_env.observation_space)
            probe_env.close()
        self.action_space = action_space
        self.observation_space = observation_space
        self._dim_s, self._dim_u = dim_s, dim_u

    def _status_ptr(self, rank: int) -> int:
        return self._status_base + self._layout.status_offset(rank)

    def _wait_all(self, expected: int) -> None:
        rc = self._lib.shm_wait_all(
            self._status_base, self.num_envs, _STATUS_BYTES, expected, self._timeout_ns
        )
        if rc == -1:
            raise TimeoutError("shm vec env: worker did not respond within timeout")
        if rc >= 1000:
            raise RuntimeError(f"shm vec env: worker {rc - 1000} reported an error")

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ShmVecEnv is closed")

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self._check_open()
        if self._pending:
            # A RESET posted while a worker is mid-step would race its late DONE and
            # hand back stale step output as the reset observation.
            raise RuntimeError("reset called with a step pending; call step_wait first")
        base = self._base_seed if seed is None else seed
        if base < 0:
            # negative seeds are the in-band close sentinel for workers
            raise ValueError("ShmVecEnv seeds must be non-negative")
        if base + self.num_envs - 1 > np.iinfo(np.int32).max:
            raise ValueError("ShmVecEnv seeds must fit in int32")
        for rank in range(self.num_envs):
            self._seeds[rank][0] = base + rank
            self._lib.shm_store(self._status_ptr(rank), _RESET)
        self._wait_all(_DONE)
        return np.stack(
            [self._slots[r][self._dim_u:self._dim_u + self._dim_s].copy()
             for r in range(self.num_envs)]
        )

    def step_async(self, actions: np.ndarray) -> None:
        self._check_open()
        if self._pending:
            raise RuntimeError("step_async called with a step already pending")
        actions = np.asarray(actions, np.float32).reshape(self.num_envs, self._dim_u)
        for rank in range(self.num_envs):
            self._slots[rank][: self._dim_u] = actions[rank]
            self._lib.shm_store(self._status_ptr(rank), _STEP)
        self._pending = True

    def step_wait(self):
        if not self._pending:
            raise RuntimeError("step_wait called without step_async")
        self._pending = False
        self._wait_all(_DONE)
        du, ds = self._dim_u, self._dim_s
        obs = np.stack([self._slots[r][du:du + ds].copy() for r in range(self.num_envs)])
        rew = np.array([self._slots[r][du + ds] for r in range(self.num_envs)], np.float32)
        done = np.array([self._slots[r][du + ds + 1] > 0.5 for r in range(self.num_envs)])
        return obs, rew, done, [{}] * self.num_envs

    def step(self, actions: np.ndarray):
        self.step_async(actions)
        return self.step_wait()

    def render(self):
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pending = False
        for rank in range(self.num_envs):
            ptr = self._status_ptr(rank)
            if self._lib.shm_load(ptr) == _STEP:
                # Posting the close sentinel while the worker is mid-step would be
                # clobbered by its late DONE, leaving the worker blocked in shm_wait
                # until the join timeout hard-terminates it mid-env.step. Covers both a
                # pending step_async and a step_wait that timed out: grant one grace
                # period for the in-flight step to finish before posting the sentinel.
                self._lib.shm_wait(ptr, _DONE, _ERROR, self._timeout_ns)
            self._seeds[rank][0] = -1
            self._lib.shm_store(ptr, _RESET)
        for p in self._procs:
            # 15 s: generous enough that a worker mid-env.step on an oversubscribed host
            # (e.g. pytest -n 4 on 4 cores) still exits cleanly; terminate() remains the
            # hard fallback for a genuinely wedged worker.
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
        # Release all exported buffer views before closing the shared memory segment.
        self._slots = []
        self._seeds = []
        self._status_base = None
        import gc

        gc.collect()
        try:
            self._shm.close()
            self._shm.unlink()
        except (BufferError, FileNotFoundError):
            pass


def _gym_env_ctor(env_id: str, env_kwargs: dict):
    """Module-level gym factory — picklable, so ShmVecEnv can use forkserver workers."""
    import gymnasium

    return gymnasium.make(env_id, **env_kwargs)


def make_shm_vec_env(
    env_id: str,
    num_envs: int = 1,
    base_seed: int = 0,
    start_method: Optional[str] = None,
    **env_kwargs,
) -> ShmVecEnv:
    """N gymnasium envs over the shared-memory transport."""
    import gymnasium

    probe = gymnasium.make(env_id, **env_kwargs)
    action_space = as_box_space(probe.action_space)
    observation_space = as_box_space(probe.observation_space)
    probe.close()

    env_fn = functools.partial(_gym_env_ctor, env_id, env_kwargs)

    return ShmVecEnv(
        [env_fn] * num_envs,
        dim_s=observation_space.dim,
        dim_u=action_space.dim,
        base_seed=base_seed,
        action_space=action_space,
        observation_space=observation_space,
        start_method=start_method,
    )
