"""One rank's work in a traced step, per device: the port's counterpart of
the reference's ``runtime/hlo_cost.py``.

The reference reads XLA's optimized, SPMD-partitioned HLO, whose shapes are
one device's.  The port compiles nothing, so it counts at dispatch: a
``TorchDispatchMode`` that lets every DTensor op pass (DTensor's sharding
propagation then dispatches the op on each rank's local tensors) and counts
the local ops it sees.  Local shapes are counted the same way outside and
inside ``local_map`` regions (``shd.local``), whose bodies dispatch local
tensors themselves.  A counter at DTensor's level (``FlopCounterMode``)
would see global shapes outside those regions and local ones inside.

Counted (``OpCounter.result()``):

  flops        ``2 * M * N * K`` of every matrix product and convolution
               (``torch.utils.flop_counter``'s formulas, the reference's
               ``dot`` convention); elementwise work is not counted.
  bytes        the local bytes every dispatched op reads and writes (each
               distinct input tensor once, each output once; an in-place
               op's destination counts as read and written).  Views,
               allocations and collectives move nothing here.  Eager
               PyTorch fuses nothing, so this is what the port moves; the
               reference counts 2 x the output of fused HLO ops, and the
               two are not held equal.
  collectives  per kind (the reference's names: ``all-gather``,
               ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
               ``collective-permute``, and ``broadcast``) the local output
               bytes, and ``n_ops``: the functional collectives DTensor
               issues and the ``c10d`` calls the port makes itself.
  kernels      launches, bytes and integer operations a hand-written
               kernel's wrapper records for itself (``record_kernel``),
               where it traces a fake launch.
  sites        with ``sites=True``, the flops by the model line each
               product comes from (``site_flops``; the backward's by its
               forward line under ``torch.autograd.set_detect_anomaly``),
               and each collective kind's bytes and ``n_ops`` by the line
               that issued it (``site_collectives``).
  memory       the reference's ``memory_analysis_dict`` keys, defined for
               the port: ``argument_size_in_bytes`` the local bytes of the
               step's inputs, ``output_size_in_bytes`` of its outputs,
               ``temp_size_in_bytes`` the peak of live local storage made
               during the step (storages tracked with their lifetimes,
               the backward's included) less what the outputs keep,
               ``alias_size_in_bytes`` outputs that share an input's
               storage, and ``peak_bytes_per_device_est`` by the
               reference's formula (arguments + outputs + temp - alias:
               the arguments and the live peak).

The counts are the same on fake tensors (``launch/dryrun.py``) and on real
ones (a gloo rank), which the tests hold.
"""

from __future__ import annotations

import functools
import os
import re
import traceback
import weakref
from contextlib import contextmanager
from typing import Any, Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import roofline

_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}

_ACTIVE: list["OpCounter"] = []


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list[torch.Tensor]:
    return [_local(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLL_NAMESPACES:
        return None
    return _KINDS.get(func._overloadpacket.__name__)


class OpCounter(TorchDispatchMode):
    """Counts the local ops dispatched inside it (see the module's
    docstring).  ``arguments``: the step's inputs (a tree of tensors or
    DTensors), which are neither temporaries nor new outputs."""

    def __init__(self, arguments: Any = (), sites: bool = False):
        super().__init__()
        self.sites = sites
        self.site_flops: dict[str, int] = {}
        self.site_collectives: dict[str, dict[str, float]] = {}
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, float] = {}
        self.n_coll_ops = 0
        self.kernels: dict[str, dict] = {}
        args = _tensors(arguments)
        self._arg_keys = {_key(t) for t in args}
        self.argument_bytes = sum({_key(t): _nbytes(t) for t in args}.values())
        # a buffer: [bytes, live tensors, its storages' weak refs and keys]; a
        # storage key -> its buffer (a collective's wait may hand the
        # buffer on in another storage: one buffer, two storages)
        self._bufs: dict[int, list] = {}
        self._buf_of: dict[int, int] = {}
        self._dying: set[int] = set()
        self.live_bytes = 0
        self.peak_live = 0
        self._paused = 0

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor dispatches the local ops
        if func._overloadpacket not in flop_registry and func.namespace == "aten":
            # a composite op (``matmul`` outside autograd) counted as the
            # ops eager runs for it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace != "aten" and func.namespace not in _COLL_NAMESPACES:
            return                        # prim.device: a fake tensor's metadata
        self._reap()
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            moved = outs if outs else ins
            n = float(sum(_nbytes(t) for t in moved))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + n
            self.n_coll_ops += 1
            if self.sites:
                at = self.site_collectives.setdefault(_site(), {"n_ops": 0})
                at[kind] = at.get(kind, 0.0) + n
                at["n_ops"] += 1
        elif func.namespace != "aten":
            pass                          # wait_tensor: moves nothing
        elif func._overloadpacket in flop_registry:
            flops = int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            self.flops += flops
            self.bytes += self._moved(ins, outs)
            if self.sites:
                site = _site()
                self.site_flops[site] = self.site_flops.get(site, 0) + flops
        elif not func.is_view and func._overloadpacket.__name__ not in _ALLOC:
            self.bytes += self._moved(ins, outs)
        in_keys = [_key(t) for t in ins]
        hand_on = func.namespace == "_c10d_functional" and kind is None
        for t in outs:
            if hand_on and in_keys and in_keys[0] in self._buf_of:
                self._track(t, False, self._buf_of[in_keys[0]])
            else:
                self._track(t, func.is_view or _key(t) in in_keys)
        if self.live_bytes > self.peak_live:
            self.peak_live = self.live_bytes

    @staticmethod
    def _moved(ins, outs) -> int:
        seen = {id(t): _nbytes(t) for t in ins}
        return sum(seen.values()) + sum(_nbytes(t) for t in outs)

    # -- storage lifetimes -------------------------------------------------
    def _track(self, t: torch.Tensor, aliases_input: bool, buf: int | None = None) -> None:
        """Count ``t``'s storage as live until it and every tensor on it die
        (``buf``: the buffer ``t`` carries on, a collective's result)."""
        k = _key(t)
        if buf is None:
            buf = self._buf_of.get(k)
        if buf is None:
            if aliases_input or k in self._arg_keys:
                return
            buf = k
            self._bufs[buf] = [t.untyped_storage().nbytes(), 0, [], []]
            self.live_bytes += self._bufs[buf][0]
        entry = self._bufs[buf]
        if self._buf_of.get(k) != buf:
            self._buf_of[k] = buf
            entry[2].append(StorageWeakRef(t.untyped_storage()))
            entry[3].append(k)
        entry[1] += 1
        self._dying.discard(buf)
        weakref.finalize(t, self._dropped, buf)

    def _dropped(self, buf: int) -> None:
        entry = self._bufs.get(buf)
        if entry is not None:
            entry[1] -= 1
            if entry[1] == 0:
                self._dying.add(buf)

    def _reap(self) -> None:
        """Buffers whose tensors died are freed once nothing else (a tensor
        autograd saved) holds their storages."""
        for buf in list(self._dying):
            n, _, refs, keys = self._bufs[buf]
            if all(r.expired() for r in refs):
                self.live_bytes -= n
                del self._bufs[buf]
                for k in keys:
                    if self._buf_of.get(k) == buf:
                        del self._buf_of[k]
                self._dying.discard(buf)

    # -- kernels and results ----------------------------------------------
    def record_kernel(self, name: str, n_bytes: int, n_ops: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0, "int_ops": 0})
        k["launches"] += 1
        k["bytes"] += int(n_bytes)
        k["int_ops"] += int(n_ops)
        self.bytes += int(n_bytes)

    def memory(self, outputs: Any) -> dict:
        """The reference's memory keys for a step that returned ``outputs``."""
        self._reap()
        outs = {}
        for t in _tensors(outputs):
            outs.setdefault(_key(t), _nbytes(t))
        alias = sum(n for k, n in outs.items() if k in self._arg_keys)
        new = sum(self._bufs[b][0] for b in {self._buf_of[k] for k in outs
                                              if k in self._buf_of})
        return roofline.memory_analysis_dict({
            "argument_size_in_bytes": self.argument_bytes,
            "output_size_in_bytes": sum(outs.values()),
            "temp_size_in_bytes": max(self.peak_live - new, 0),
            "alias_size_in_bytes": alias})

    def result(self, outputs: Any = ()) -> dict:
        """``{"flops", "bytes", "collectives", "kernels", "memory"}`` (the
        collectives with ``n_ops``, as the reference's)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {**self.collectives, "n_ops": self.n_coll_ops},
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "memory": self.memory(outputs)}

    @contextmanager
    def paused(self) -> Iterator[None]:
        """Ops inside are not counted (the sharding propagator's own
        bookkeeping)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __enter__(self):
        if not _ACTIVE:
            _patch_dtensor_bookkeeping()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if not _ACTIVE:
            _restore_dtensor_bookkeeping()
        return super().__exit__(*exc)


_MODELS = os.path.join("repro_torch", "models", "")
_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _site() -> str:
    """The model line a product comes from: the innermost frame under
    ``repro_torch/models/`` of the running stack (the forward, a
    checkpoint's recompute), else of the forward that made the autograd
    node running (the backward: "grad of ...", which needs anomaly mode's
    tracebacks).  "?" where neither has one."""
    for fr in reversed(traceback.extract_stack()):
        if _MODELS in fr.filename:
            return f"{os.path.basename(fr.filename)}:{fr.lineno} {fr.name}"
    node = torch._C._current_autograd_node()
    tb = node.metadata.get("traceback_") if node is not None else None
    for line in reversed(tb or []):
        m = _FRAME.search(line)
        if m and _MODELS in m.group(1):
            return f"grad of {os.path.basename(m.group(1))}:{m.group(2)} {m.group(3)}"
    return "?"


def active() -> OpCounter | None:
    """The innermost counter, or None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, n_bytes: int, n_ops: int) -> None:
    """A hand-written kernel's launch on fake tensors: its bytes and
    integer operations into the active counter (none: nothing)."""
    c = active()
    if c is not None:
        c.record_kernel(name, n_bytes, n_ops)


# (class, name, original) of each function patched while a counter is active
_PATCHED: list[tuple[type, str, Any]] = []


def _bookkeeping_targets() -> list[tuple[type, str, bool]]:
    """(class, function, run on real tensors) of DTensor's bookkeeping."""
    from torch.distributed.tensor import _sharding_prop, placement_types

    prop = _sharding_prop.ShardingPropagator
    strided = getattr(placement_types, "_StridedShard", None)
    targets = [(prop, "propagate_op_sharding_non_cached", False),
               (prop, "_propagate_tensor_meta_non_cached", False),
               (strided, "local_shard_size_and_offset", True)]
    missing = [f"{getattr(cls, '__name__', cls)}.{name}" for cls, name, _ in targets
               if cls is None or name not in cls.__dict__]
    if missing:
        raise RuntimeError(
            f"op_cost: torch {torch.__version__} has no {', '.join(missing)}; without "
            "pausing there the counter would count DTensor's global-shape bookkeeping")
    return targets


def _patch_dtensor_bookkeeping() -> None:
    """DTensor's own host bookkeeping dispatches ops too: the sharding
    propagator runs each op once on fake tensors of the GLOBAL shapes to
    learn its output's metadata (cached after the first call of a schema),
    and computes a ``_StridedShard``'s local size from an index tensor it
    makes with ``torch.arange`` and reads back.  None of it is the step's
    work, so it is not counted, on fake and real runs alike; the second
    runs on real tensors, since a fake one cannot be read.  Patched when
    the outermost counter enters and restored when it exits
    (``_restore_dtensor_bookkeeping``); a torch without one of these
    functions raises."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    for cls, name, unfake in _bookkeeping_targets():
        raw = cls.__dict__[name]
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def wrapped(*args, _fn=fn, _unfake=unfake, **kwargs):
            c = active()
            with (unset_fake_temporarily() if _unfake else _nothing()), \
                    (c.paused() if c else _nothing()):
                return _fn(*args, **kwargs)

        functools.update_wrapper(wrapped, fn)
        _PATCHED.append((cls, name, raw))
        setattr(cls, name, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)


def _restore_dtensor_bookkeeping() -> None:
    while _PATCHED:
        cls, name, raw = _PATCHED.pop()
        setattr(cls, name, raw)


@contextmanager
def _nothing() -> Iterator[None]:
    yield
