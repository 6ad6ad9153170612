"""Runtime hygiene guards for steady-state serving loops (port of
``repro.analysis.guards``).

``no_recompiles()`` asserts that a region prepares no new program: no
``nvcc`` build of the kernel library (``kernels/build.py``), no CUDA-graph
capture (``runtime/graphs.py``) and no step shape that a fleet or engine
runs eagerly for the first time (the reference's ``_shapes_seen``).  These
are what the reference's XLA compilations are to the port: the steady
state of a warmed, bucketed fleet has none.

``no_transfers()`` asserts that a region never makes the host wait for
the device.  On the card it sets ``torch.cuda.set_sync_debug_mode("error")``
for the region, so every synchronising CUDA call (a blocking copy either
way, ``.item()``, ``.cpu()``, a stream or device synchronise) raises.  On
the CPU there is no device to wait for, so, as the reference does for its
CPU backend, it instruments the host-read surface of tensors
(``numpy``, ``item``, ``tolist``, ``__array__`` and the scalar
conversions) to raise inside the region.  Host staging buffers, marked
``_host_staging`` by the fleet, are exempt: writing codes through their
``numpy()`` view is the ingest path, not a device read.

The reference ships both as pytest fixtures in its ``tests/conftest.py``;
the port's tests define their own fixtures in their files.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import build
from repro_torch.runtime import graphs


class GuardViolation(AssertionError):
    """A guarded region broke a serving-hygiene invariant."""


class _Recorder:
    """What a ``no_recompiles`` region prepared so far."""

    def __init__(self) -> None:
        self._start = (len(build.BUILD_LOG), len(graphs.CAPTURE_LOG),
                       len(graphs.EAGER_LOG))

    @property
    def builds(self) -> list[str]:
        return build.BUILD_LOG[self._start[0]:]

    @property
    def captures(self) -> list[str]:
        return graphs.CAPTURE_LOG[self._start[1]:]

    @property
    def eager(self) -> list[str]:
        return graphs.EAGER_LOG[self._start[2]:]

    @property
    def compiled(self) -> list[str]:
        """Every event, tagged ``build:``, ``capture:`` or ``eager:``."""
        return ([f"build:{b}" for b in self.builds]
                + [f"capture:{c}" for c in self.captures]
                + [f"eager:{e}" for e in self.eager])


@contextlib.contextmanager
def no_recompiles(allow: int = 0):
    """Fail with :class:`GuardViolation` if the region builds, captures or
    first runs eagerly more than ``allow`` programs in all.  Yields the
    recorder (``builds``, ``captures``, ``eager``, ``compiled``)."""
    rec = _Recorder()
    yield rec
    if len(rec.compiled) > allow:
        raise GuardViolation(
            f"region prepared {len(rec.compiled)} program(s) (allowed "
            f"{allow}): {', '.join(rec.compiled)}")


_SYNC_METHODS = ("numpy", "item", "tolist", "__array__", "__float__",
                 "__int__", "__bool__", "__index__", "__complex__")


def _blocked(name: str, orig):
    def method(self, *args, **kwargs):
        if getattr(self, "_host_staging", False):
            return orig(self, *args, **kwargs)
        raise GuardViolation(
            f"implicit host read via Tensor.{name} inside a no_transfers() "
            "region")
    return method


@contextlib.contextmanager
def no_transfers(device=None):
    """Fail with :class:`GuardViolation` when the region makes the host
    wait for the device.  ``device`` (default: the card when there is one)
    picks the mode: CUDA sync-debug errors on the card, the instrumented
    tensor surface on the CPU."""
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    if cuda:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        except RuntimeError as ex:
            if "synchronizing" in str(ex):
                raise GuardViolation(
                    f"host sync inside a no_transfers() region: {ex}") from ex
            raise
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return
    saved = {name: torch.Tensor.__dict__.get(name) for name in _SYNC_METHODS}
    try:
        for name in _SYNC_METHODS:
            setattr(torch.Tensor, name, _blocked(name, getattr(torch.Tensor, name)))
        yield
    finally:
        for name, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)
