"""CUDA-graph capture of the serving steps: the port's counterpart of the
reference's warmed executables.

A fleet step is a few dozen small launches (emission masks, owner sort,
the fleet kernel, threshold packing, AM scoring, the state update).  A
warmed fleet or engine captures each step once as a ``torch.cuda.CUDAGraph``
over static input and state tensors, and each round replays it: one
launch where the eager step makes dozens.

``capture`` runs the step once eagerly first (on clones, so nothing of the
caller's state moves), which loads the kernel library's CUDA module and
fills every lazily built constant before the capture, where neither is
allowed.  The wrappers count launches where they launch (``.launches``); a
capture launches nothing, so the launches made while capturing are taken
back and each ``replay`` adds them, so counts stay counts of kernels run.

A ``Program`` is one warm-up entry as the fleet or engine makes it
(``StreamingFleet._step_program``/``_adapt_program``,
``ServingEngine._dispatch_program``): the body, its warm-up, the static
state leaves the body writes in place and the static inputs copied in
before a replay.  ``capture`` records it; the audit
(``analysis/audit.py``) runs the same object, so both read one program.

``CAPTURE_LOG`` and ``EAGER_LOG`` list, for ``analysis/guards.py``, every
capture and every step shape a fleet or engine first ran eagerly (the
reference's ``_shapes_seen``): the port's counterparts of compilations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

CAPTURE_LOG: list[str] = []
EAGER_LOG: list[str] = []


@dataclass
class Program:
    """One warm-up entry's program.  ``body()`` reads ``inputs`` and
    ``state``, writes the new state into ``state``'s tensors and returns
    its output tensors; ``eager(leaves)`` is the step the body makes, on
    the leaves given (a name -> tensor dict like ``state``), returning the
    new leaves (a leaf the step passes through comes back as the same
    tensor).  ``counted``: the kernel wrappers whose launches a capture
    holds."""

    name: str
    kind: str                                   # "step", "adapt" or "engine"
    body: Callable[[], tuple]
    state: dict = field(default_factory=dict)
    inputs: dict = field(default_factory=dict)
    eager: Callable[[dict], dict] | None = None
    counted: tuple = ()

    def warm(self):
        """The body's kernels without writing the state: ``eager`` on
        copies of the state, or ``body`` for a program with no ``eager``
        (one that keeps no state)."""
        if self.eager is None:
            return self.body()
        return self.eager({k: t.clone() for k, t in self.state.items()})


class StepGraph:
    """One captured step: the graph, its static outputs (overwritten by
    every replay) and the counted kernel launches it holds."""

    def __init__(self, name: str, graph, outputs: tuple, launches: dict,
                 capture_ms: float):
        self.name = name
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.capture_ms = capture_ms

    def replay(self) -> tuple:
        """Replay on the current stream; returns the static outputs.  A
        replay that fails raises: nothing demotes a broken capture to eager
        launches, which would hide it."""
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.outputs


def capture_program(program: Program, pool) -> StepGraph:
    """``capture`` of a ``Program``."""
    return capture(program.name, program.body, warm=program.warm, pool=pool,
                   counted=program.counted)


def capture(name: str, body, *, warm, pool, counted=()) -> StepGraph:
    """Capture ``body()`` (which reads and writes only static tensors and
    returns its output tensors) into a graph in memory pool ``pool``.
    ``warm()`` first runs the same kernels eagerly on a side stream;
    ``counted`` are the kernel wrappers whose ``launches`` the graph holds.
    Records the capture in ``CAPTURE_LOG``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = {w: w.launches for w in counted}
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=pool):
            outputs = tuple(body())
    finally:
        held = {w: w.launches - n for w, n in before.items()}
        for w, n in before.items():
            w.launches = n
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    CAPTURE_LOG.append(name)
    return StepGraph(name, graph, outputs, {w: n for w, n in held.items() if n},
                     ms)
