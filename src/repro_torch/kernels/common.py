"""The dispatch rule and argument checks shared by the kernel wrappers.

A wrapper sends CPU tensors to its plain PyTorch version and CUDA tensors to
its CUDA kernel.  There is no fallback: a CUDA tensor that the kernel cannot
take raises, and so does a mix of devices.  Fake tensors (``FakeTensorMode``,
the dry-run's trace) go the kernel's way on any device: a wrapper that can
trace its launch records it (``runtime/op_cost.py``) and launches nothing; a
mix of fake and real operands raises.

A wrapper's plain branch runs through ``plain``: to the program audit
(``analysis/audit.py``) a kernel's plain version is one operation, as the
CUDA kernel is one launch, and its int64 carriers are its own.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor


# the observer of the plain versions in this context (``observe_plain``):
# called as observer(name, fn, args, kwargs) in place of fn(*args, **kwargs)
_PLAIN_OBSERVER = contextvars.ContextVar("plain_observer", default=None)


@contextlib.contextmanager
def observe_plain(observer):
    """Within this block, in this context only, every wrapper's plain
    version runs through ``observer`` (the program audit's recorder)."""
    token = _PLAIN_OBSERVER.set(observer)
    try:
        yield
    finally:
        _PLAIN_OBSERVER.reset(token)


def plain(name: str, fn, *args, **kwargs):
    """Kernel ``name``'s plain version ``fn`` on the wrapper's operands:
    a call, or within ``observe_plain`` one operation its observer runs."""
    observer = _PLAIN_OBSERVER.get()
    if observer is None:
        return fn(*args, **kwargs)
    return observer(name, fn, args, kwargs)


def use_plain(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); raises for anything else.  Reads the tensors' flags, not their
    ``device`` objects: this runs on every launch.  Fake tensors: False
    (the kernel's launch wrapper traces them).  A CUDA build makes them
    CUDA tensors, which take the kernel's way with no further test; only
    CPU ones are looked at here."""
    if all(t.is_cpu for t in tensors):
        return not all_fake(*tensors)
    if all(t.is_cuda for t in tensors):
        index = tensors[0].get_device()
        if any(t.get_device() != index for t in tensors):
            raise ValueError("kernel operands lie on different CUDA devices")
        return False
    kinds = sorted({t.device.type for t in tensors})
    raise ValueError(f"kernel operands on unsupported devices: {kinds}")


def all_fake(*tensors: torch.Tensor) -> bool:
    """True when every operand is fake (the dry-run's trace), False when
    none is; a mix of fake and real operands raises."""
    fake = [isinstance(t, FakeTensor) for t in tensors]
    if any(fake) and not all(fake):
        raise ValueError("kernel operands mix fake and real tensors")
    return fake[0]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None, contiguous: bool = True) -> None:
    """Check what a CUDA kernel takes: dtype, shape (None = any extent)
    and contiguity (unless the kernel takes strides itself)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    # a shape given in full is one tuple comparison; extents left open
    # (None) are compared one by one
    if shape is not None and t.shape != shape:
        if t.ndim != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_rows(codes: torch.Tensor, window: int) -> tuple[int, int]:
    """How the encoder kernels read a (B, T, C) code stream in place, cut to
    whole frames of ``window`` cycles (``frame_view`` without the view):
    (frames a row, bytes between rows).  Each row must be contiguous; the
    rows may lie any distance apart (``codes[1:]``, ``codes[::2]``)."""
    b, t, c = codes.shape
    st = codes.stride()
    if (st[2] != 1 and c > 1) or (st[1] != c and t > 1):
        raise ValueError("codes: each batch row must be contiguous, got strides "
                         f"{st} for shape {tuple(codes.shape)}")
    return t // window, st[0] * codes.element_size()
