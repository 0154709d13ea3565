"""Decoding of zstd frames through the system's ``libzstd`` (``ctypes``; decode only).

Orbax's checkpoints compress their OCDBT manifests and B-tree nodes and each zarr chunk with
zstd. The library is found with ``ctypes.util.find_library("zstd")`` at the first call; where
it is missing, or a frame does not decode, :func:`decompress` raises an error that names the
library or the frame's fault. There is no second route.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

__all__ = ["decompress"]

# ZSTD_getFrameContentSize's two markers: the header does not say, or it is not a frame.
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.cache
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd not found (ctypes.util.find_library('zstd') gave None): "
                      "install the zstd library (libzstd.so.1) to read Orbax checkpoints")
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise OSError(f"libzstd ({name}) failed to load: {e}") from e
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for fn, restype, argtypes in (
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ptr, size_t]),
        ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createDStream", ptr, []),
        ("ZSTD_freeDStream", size_t, [ptr]),
        ("ZSTD_initDStream", size_t, [ptr]),
        ("ZSTD_DStreamOutSize", size_t, []),
        ("ZSTD_decompressStream", size_t,
         [ptr, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
    ):
        f = getattr(lib, fn)
        f.restype, f.argtypes = restype, argtypes
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """The content of the zstd frame ``data``. A frame that does not state its content size
    (as a streaming writer leaves it) is decoded through the streaming API."""
    lib = _lib()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError(f"zstd: not a zstd frame (starts {bytes(data[:4]).hex()})")
    if size == _CONTENTSIZE_UNKNOWN:
        return _decompress_stream(lib, src, len(data))
    dst = ctypes.create_string_buffer(max(size, 1))
    written = _check(lib, lib.ZSTD_decompress(dst, size, src, len(data)), "decompress")
    if written != size:
        raise ValueError(f"zstd: the frame gave {written} bytes, its header says {size}")
    return dst.raw[:size]


def _decompress_stream(lib, src, n: int) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "init")
        chunk = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(chunk)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), n, 0)
        parts, left = [], 1
        while inb.pos < n or left:
            outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
            before = inb.pos
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "decompress")
            parts.append(dst.raw[:outb.pos])
            if left and inb.pos == n and inb.pos == before and outb.pos == 0:
                raise ValueError("zstd: the frame is truncated")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)
