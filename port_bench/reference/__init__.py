"""Plain references of the benchmark's cells, in PyTorch, written from the published methods:
the dynamics ensemble (``model.py``), the planners of an ``act()`` (``planning.py``) and the
first optimizer steps of the trainer (``training.py``). They import nothing of the program
and take nothing it has made; what they read of the program's state, they read to follow
or to judge it, as ``PERF.md`` sets out.

Every matrix product of a reference goes through :func:`matmul`, in the precision the caller
sets with :func:`precision`: ``"float32"`` (TF32 off), or the control's ``"tf32"``, in which
both operands are rounded to TF32 (10 mantissa bits, to nearest) and the products summed in
float32, as the tensor cores do, in the forward and in the backward pass. The rounding is done
here, so the control's precision does not depend on which kernel cuBLAS picks (it takes no
TF32 path for a matrix-vector product).
"""
import contextlib
import contextvars
import functools

__all__ = ["CONTROL_PRECISION", "matmul", "precision"]

# The nearest precision below the one a configuration states: the control's.
CONTROL_PRECISION = {"float32": "tf32"}
_PRECISION = contextvars.ContextVar("reference_precision", default="float32")


@contextlib.contextmanager
def precision(kind: str):
    """The references' matrix products in ``kind`` (``"float32"`` or ``"tf32"``); TF32 off
    in the library either way."""
    import torch

    if kind not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {kind!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    token = _PRECISION.set(kind)
    try:
        yield
    finally:
        _PRECISION.reset(token)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value: 13 low mantissa bits cleared."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@functools.lru_cache(maxsize=None)
def _tf32_product():
    import torch

    class Tf32Matmul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return torch.matmul(to_tf32(a), to_tf32(b))

        @staticmethod
        def backward(ctx, grad):
            a, b = ctx.saved_tensors
            g = to_tf32(grad)
            return (torch.matmul(g, to_tf32(b).transpose(-1, -2)),
                    torch.matmul(to_tf32(a).transpose(-1, -2), g))

    return Tf32Matmul.apply


def matmul(a, b):
    """``a @ b`` in the precision set by :func:`precision`."""
    import torch

    if _PRECISION.get() == "tf32":
        return _tf32_product()(a, b)
    return torch.matmul(a, b)
