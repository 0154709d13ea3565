"""The block-diagonal linear layer as a hand-written tensor-core kernel, for the RSSM's core
(``models/rssm.py::block_linear``), with its weight pack.

The kernel (``ops/csrc/block_gemm.cu``) computes ``x[g] @ w[g] + b[g]`` for every group ``g``
as split-operand 3xTF32 ``wgmma``, float32-accurate: each operand is ``hi + lo``, two TF32
values rounded to nearest, ties away, and the sum is ``hi.hi + hi.lo + lo.hi``. It replaces no
kernel of the JAX package; the design and its bound are in the source's notes.

:func:`block_pack` splits a block weight ``[groups, in, out]`` once into the K-major halves
the kernel reads, ``[groups, out, in]`` each; :func:`packed` caches them against the weight
tensor's identity and version counter, so an edit in place or a new tensor is packed anew.
:func:`takes_kernel` is the rule, on the shape alone, for which layers the kernel tiles
(``ops/backend_select.py`` refuses an RSSM on the card whose block layers it does not);
:func:`block_gemm` launches it on CUDA tensors, adds one to ``block_gemm.launches``, and raises
on anything else: there is no fallback.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from blackbox_mpc_torch.utils.profiling import span

__all__ = ["TILE_K", "TILE_N", "block_gemm", "block_pack", "gemm_attributes", "packed",
           "takes_kernel", "tf32_round"]

# The kernel's K stage and output tile (kTileK, kTileN in ops/csrc/block_gemm.cu).
TILE_K = 32
TILE_N = 128


def takes_kernel(fan_in: int, fan_out: int) -> bool:
    """Whether the kernel tiles a block layer of ``fan_in -> fan_out`` units a group: ``fan_in``
    a multiple of ``TILE_K``, ``fan_out`` of ``TILE_N``. Rows are free."""
    return fan_in % TILE_K == 0 and fan_out % TILE_N == 0 and fan_in > 0 and fan_out > 0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, the low 13 bits zero), ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def block_pack(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``w [groups, in, out]`` float32 -> ``(hi, lo)``, each ``[groups, out, in]`` (K-major):
    ``hi`` the TF32 rounding of ``w``, ``lo`` that of ``w - hi``."""
    t = w.detach().float().transpose(1, 2).contiguous()
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


_packs: dict = {}  # id(w) -> (weakref to w, w._version, hi, lo)


def packed(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`block_pack` of ``w``, kept while ``w`` lives and packed anew where ``w`` is
    another tensor or was changed in place since (its version counter). ``packed.calls``
    counts the packs. A pack is never made inside a CUDA graph capture, whose kernels do not
    run while it records: run one eager call on new weights first. A weight made under
    ``torch.inference_mode()`` has no version counter, so an edit of it in place could not be
    seen: it is refused."""
    if w.is_inference():
        raise ValueError("block weights made under torch.inference_mode() carry no version "
                         "counter, so an edit in place would leave their pack stale; make them "
                         "outside the mode (a clone() there will do)")
    key = id(w)
    entry = _packs.get(key)
    if entry is None or entry[0]() is not w or entry[1] != w._version:
        if w.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("block weights packed inside a CUDA graph capture: new or edited "
                               "weights need one eager call before a capture")
        packed.calls += 1

        def drop(ref, key=key):
            if _packs.get(key, (None,))[0] is ref:
                del _packs[key]

        entry = _packs[key] = (weakref.ref(w, drop), w._version, *block_pack(w))
    return entry[2], entry[3]


packed.calls = 0


def _lib():
    from blackbox_mpc_torch.ops._build import load_library

    lib = load_library("block_gemm")
    if not getattr(lib, "_bbmpc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bbmpc_block_gemm.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.bbmpc_block_gemm.restype = i
        lib.bbmpc_block_gemm_attributes.argtypes = [p]
        lib.bbmpc_block_gemm_attributes.restype = i
        lib.bbmpc_block_gemm_prepare.restype = i
        err = lib.bbmpc_block_gemm_prepare()  # before any launch, so before any capture
        if err != 0:
            raise RuntimeError(f"block gemm kernel set-up failed: CUDA error {err}")
        lib._bbmpc_typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as TMA reads it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def block_gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: ``x [groups, rows, in]``, ``w [groups, in, out]``, ``b [groups,
    out]``, all float32 on one CUDA device, -> ``x @ w + b`` ``[groups, rows, out]``, launched
    on the current stream. Raises on a shape :func:`takes_kernel` refuses, on other devices or
    dtypes, where autograd would record (the kernel has no backward), and where the launch
    fails; there is no fallback."""
    with span("kernels.block"):
        groups, rows, fan_in = x.shape
        fan_out = w.shape[2]
        if not x.is_cuda:
            raise ValueError(f"the block gemm kernel runs on cuda tensors, not {x.device}")
        if any(t.dtype != torch.float32 or t.device != x.device for t in (w, b)) \
                or x.dtype != torch.float32:
            raise ValueError("the block gemm kernel takes float32 x, w and b on one device")
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
            raise ValueError("the block gemm kernel has no backward: call it with grad "
                             "disabled or on tensors that require none")
        if tuple(w.shape) != (groups, fan_in, fan_out) or tuple(b.shape) != (groups, fan_out):
            raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                             f"{tuple(b.shape)} do not make a block layer")
        if not takes_kernel(fan_in, fan_out) or rows < 1:
            raise ValueError(f"the block gemm kernel does not tile {fan_in} -> {fan_out} "
                             f"(in a multiple of {TILE_K}, out of {TILE_N})")
        hi, lo = packed(w)
        x, b = _aligned(x), _aligned(b)
        out = torch.empty((groups, rows, fan_out), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().bbmpc_block_gemm(x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                          b.data_ptr(), out.data_ptr(), groups, rows, fan_in,
                                          fan_out, stream)
        if err != 0:
            raise RuntimeError(f"block gemm kernel launch failed: error {err}")
        block_gemm.launches += 1
        return out


block_gemm.launches = 0


GEMM_FIELDS = ("smem_bytes", "blocks_per_sm", "registers", "local_bytes", "threads")


def gemm_attributes() -> dict:
    """What a launch occupies: shared memory a CTA, CTAs a multiprocessor, registers a thread
    (at compile time), local (spilled) bytes, threads a CTA."""
    out = (ctypes.c_int * len(GEMM_FIELDS))()
    err = _lib().bbmpc_block_gemm_attributes(out)
    if err != 0:
        raise RuntimeError(f"block gemm attribute query failed: CUDA error {err}")
    return dict(zip(GEMM_FIELDS, list(out)))
