"""Named ranges of the program's layers in a ``torch.profiler`` trace.

``span(name)`` marks one layer's call: while a ``torch.profiler`` profile
is recording, a ``record_function("repro_torch." + name)`` range; otherwise
a shared ``nullcontext`` that enters no range and allocates nothing.  The
profiler's Chrome trace is the one way out, so an operator who wraps a job
in ``torch.profiler.profile`` gets the same ranges a traced benchmark run
reads.  The ranges are on the profiler's clock, beside the device events
the calls inside them launch; a range's parent is the range that encloses
it on the same thread.

No captured body (``runtime/graphs.py``) reaches a span.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range ``repro_torch.<name>`` while a
    profile records, else a no-op."""
    # the profiler sets and clears this module-level flag as it starts and
    # stops: read it through its module on every call
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function("repro_torch." + name)
    return _OFF
