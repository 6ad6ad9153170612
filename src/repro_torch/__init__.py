"""PyTorch/CUDA port of the sparse-HDC iEEG seizure-detection system.

Mirrors the module layout of the JAX package ``repro`` (``core/``,
``kernels/<name>/{ops,ref}.py``, ``serve/``, ``data/``), which stays the
reference it is held against.  Every kernel on the ported path is a
hand-written CUDA kernel for Hopper (``kernels/csrc/``); each ``ops.py``
sends CUDA tensors to the kernel and CPU tensors to the plain PyTorch
version in ``ref.py``.

Packed hypervectors are carried as ``torch.int32`` holding the same bit
pattern as the reference's ``uint32`` words (see ``core/hv.py``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
