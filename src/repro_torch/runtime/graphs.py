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

``CAPTURE_LOG`` and ``EAGER_LOG`` list, for ``analysis/guards.py``, every
capture and every step shape a fleet or engine first ran eagerly (the
reference's ``_shapes_seen``): the port's counterparts of compilations.
"""

from __future__ import annotations

import time

import torch

CAPTURE_LOG: list[str] = []
EAGER_LOG: list[str] = []


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
