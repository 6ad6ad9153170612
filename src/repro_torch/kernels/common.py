"""The dispatch rule and argument checks shared by the kernel wrappers.

A wrapper sends CPU tensors to its plain PyTorch version and CUDA tensors to
its CUDA kernel.  There is no fallback: a CUDA tensor that the kernel cannot
take raises, and so does a mix of devices.
"""

from __future__ import annotations

import torch


def use_plain(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); raises for anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return False
    raise ValueError(f"kernel operands on unsupported devices: {sorted(kinds)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Check what a CUDA kernel takes: dtype, shape (None = any extent)
    and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None:
        if t.ndim != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
