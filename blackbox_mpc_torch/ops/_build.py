"""Builds the port's CUDA kernels from ``ops/csrc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
``ops/_build/lib<name>-<hash>.so`` on first use. The hash is of the source, of every header
``csrc/*.cuh`` (the sources share ``mlp_step.cuh``) and of the flags, so an edited source or
header is rebuilt. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh"), key=lambda path: path.name):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict:
    """Compiles ``csrc/<name>.cu`` for each name not built yet, one ``nvcc`` each, all started
    together.

    Returns ``{name: compiler output}``: with ``-Xptxas -v``, registers, shared memory and
    spills per kernel; ``""`` for a library that was already built.
    """
    logs = {name: "" for name in names}
    running = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, target))
    failures = []
    for name, proc, tmp, target in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent build never loads a partial file
            logs[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
