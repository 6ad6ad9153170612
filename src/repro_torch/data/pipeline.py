"""Host-side data pipeline (port of the reference's ``data/pipeline.py``).

* **Stateless resume**: a batch is a pure function of (config, step), so a
  restart at step k draws the same stream with no persisted iterator state
  (``data/lm.py:batch_for_step``).
* **Host slicing**: in a job of several processes each takes its rank's
  slice of the global batch; the rank and world size are
  ``torch.distributed``'s when it is initialised, else 0 and 1.
* **Placement**: ``shard_to_devices`` puts a host batch where a matching
  tree of ``runtime/sharding.py`` ``Sharding``s or devices says.
* **Prefetch**: a background thread keeps ``depth`` batches ahead of the
  training loop, so host-side batch making overlaps the card's work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch.distributed as dist

from repro_torch.models.params import tree_map
from repro_torch.runtime import sharding as shd


def host_slice(global_batch: dict, *, process_index: int | None = None,
               process_count: int | None = None) -> dict:
    """The slice of a global batch (its leading axis) this process takes."""
    initialised = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if initialised else 0
    if process_count is None:
        process_count = dist.get_world_size() if initialised else 1

    def one(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]

    return tree_map(one, global_batch)


def shard_to_devices(batch: dict, shardings) -> dict:
    """Place a (host-local) batch by a matching tree of ``Sharding``s (each
    rank keeps its part of the full batch), devices or None (left as it
    is); ``shardings=None`` passes the batch through."""
    if shardings is None:
        return batch
    return tree_map(shd.place, batch, shardings)


class Prefetcher:
    """Run ``make_batch(step)`` for steps [start, stop) on a background
    thread, ``depth`` batches ahead; iterating yields ``(step, batch)`` in
    order.  An exception in ``make_batch`` is raised by the iteration."""

    def __init__(self, make_batch: Callable[[int], dict], start: int,
                 stop: int, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_evt = threading.Event()

        def worker():
            try:
                for step in range(start, stop):
                    if self._stop_evt.is_set():
                        return
                    self._q.put((step, make_batch(step)))
            except Exception as e:  # handed to the consumer, which raises it
                self._q.put(e)
                return
            self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """Stop the worker after its current batch and drop what it queued."""
        self._stop_evt.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
