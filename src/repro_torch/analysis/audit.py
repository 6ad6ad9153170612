"""Run the serving stack's warm-up programs and audit what they dispatch
(port of ``repro.analysis.hlo_audit``).

The lint (``analysis/lint.py``) checks what the source says; this module
checks what a program does when it runs.  It reuses the serving stack's
own program makers (``StreamingFleet.programs``, made by
``_step_program``/``_adapt_program``, and
``ServingEngine._dispatch_program``), which ``warmup`` and ``prewarm``
capture, so the audited bodies are the ones a warmed fleet or engine
replays.  Each body runs once under a ``TorchDispatchMode`` that sees every
operator it dispatches, and three invariants are held per entry:

1. **State written in place** (the reference's donation aliasing).  A
   captured step updates its state only because the body writes the new
   state into the static tensors; a leaf rebound instead of copied leaves
   the replay on stale state.  Every static state leaf must keep its
   storage, equal afterwards bit for bit what the program's eager step
   gives on a copy of the state, and be the destination of an in-place
   operator in the body unless that step passes it through unchanged.  On
   the card the entry is also replayed from its CUDA graph (a warmed
   fleet's own, else one captured here), from the state it started with:
   the replay must return its static outputs, equal to the body's, and
   leave the same state in the same storages.
2. **No host escapes.**  Any operator that makes the host wait or reads
   device memory to the host fails the entry: ``_local_scalar_dense``
   (``.item()``, ``int(t)``, ``bool(t)``), ``equal``, the shapes that
   depend on the data (``nonzero``, ``masked_select``, the ``unique``
   family, ``repeat_interleave`` without ``output_size``), a copy between
   devices, and on the CPU a host read of a tensor (``numpy``, ``tolist``,
   ``__array__``).  On the card the body also runs under
   ``torch.cuda.set_sync_debug_mode("error")``.  Kernels are counted by
   the five wrappers' ``launches`` on the card and by their plain versions
   on the CPU; a kernel whose launches the program's capture does not hold
   (``Program.counted``) is reported, as the reference reports a
   ``custom_call`` outside its allowlist.
3. **No 64-bit widening.**  Every tensor an operator returns is counted by
   element type (one-element tensors excluded, as the reference excludes
   weak scalars).  A float64 or complex tensor fails the entry, and so
   does an int64 tensor from an operator that is not a cast, a factory,
   an operator that returns indices or a write into an existing tensor,
   when none of its tensor operands is int64 (a ``sum``, ``cumsum`` or
   ``prod`` over int32, uint8 or bool without ``dtype=``) or one of them
   is a narrower integer buffer (``counts_i32 + torch.arange(n)``, a
   ``where`` or ``cat`` of int32 and int64): torch's hidden promotion, the
   bug class of the reference's RPR001.  Operands of one element, bool
   masks and the index operands of indexing operators (``index``,
   ``gather``, ``index_select``, ``scatter``) do not count as narrower.
   Each finding names the operator and the innermost ``repro_torch`` line
   that dispatched it.

A kernel's plain version is one operation (``kernels/common.py::plain``,
observed within ``observe_plain``):
its int64 carriers are its own, as a Pallas call is one ``custom_call`` to
the reference and a CUDA kernel one launch on the card, so the CPU audit
and the card audit check the same program.  The reference's ``--x64`` has
no counterpart: torch's widths are always the ones that run.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import common
from repro_torch.runtime import graphs

aten = torch.ops.aten

_HOST_ESCAPES = {aten._local_scalar_dense, aten.equal, aten.is_nonzero, aten.nonzero,
                 aten.masked_select, aten._unique, aten._unique2, aten.unique_dim,
                 aten.unique_consecutive}
_CASTS = {aten._to_copy, aten.to}
_FACTORIES = {aten.arange, aten.full, aten.zeros, aten.ones, aten.empty,
              aten.empty_strided, aten.full_like, aten.zeros_like, aten.ones_like,
              aten.empty_like, aten.new_full, aten.new_zeros, aten.new_ones,
              aten.new_empty, aten.scalar_tensor, aten.lift_fresh, aten.lift_fresh_copy,
              aten.randint, aten.randperm, aten.eye}
_INDEX_OPS = {aten.argmax, aten.argmin, aten.argsort, aten.sort, aten.topk, aten.max,
              aten.min, aten.kthvalue, aten.mode, aten.median, aten.nanmedian,
              aten.cummax, aten.cummin, aten.searchsorted, aten.bucketize}
_EXPLICIT = _CASTS | _FACTORIES | _INDEX_OPS
_INDEX_ARGS = {"index", "indices"}        # schema names of indexing operands
_NOT_NARROWER = {torch.bool, torch.int64, torch.uint64}
_WIDE_FLOATS = {torch.float64, torch.complex64, torch.complex128}
_HOST_READS = ("numpy", "tolist", "__array__")

_ELEM = {torch.bool: "i1", torch.uint8: "ui8", torch.int8: "i8", torch.int16: "i16",
         torch.int32: "i32", torch.int64: "i64", torch.uint16: "ui16",
         torch.uint32: "ui32", torch.uint64: "ui64", torch.float16: "f16",
         torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64",
         torch.complex64: "c64", torch.complex128: "c128"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = {os.path.abspath(__file__), os.path.abspath(common.__file__)}
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _elem(dtype: torch.dtype) -> str:
    return _ELEM.get(dtype, str(dtype).replace("torch.", ""))


def _source() -> str:
    """The innermost ``repro_torch`` line on the stack (outside this module
    and the kernels' marker), else the innermost line outside torch."""
    f, outside = sys._getframe(1), None
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn not in _SKIP:
            if fn.startswith(_PKG + os.sep):
                return f"{os.path.relpath(fn, os.path.dirname(_PKG))}:{f.f_lineno}"
            if outside is None and not fn.startswith(_TORCH + os.sep):
                outside = f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return outside or "?"


def _narrower(t) -> bool:
    """An integer buffer narrower than int64 (more than one element; a
    bool is a mask, not a buffer)."""
    return (isinstance(t, torch.Tensor) and t.numel() > 1 and t.dtype not in _NOT_NARROWER
            and not t.dtype.is_floating_point and not t.dtype.is_complex)


def _other_device(dst: torch.device, src: torch.device) -> bool:
    """A copy between devices (``cuda`` without an index is the current
    card, taken as the source's)."""
    return dst.type != src.type or (dst.index is not None and dst.index != src.index)


def _wrappers() -> dict:
    """The five kernel wrappers, by the kernel's name, whose ``launches``
    count the card's launches."""
    from repro_torch.kernels.dense_hdc.ops import dense_encoder
    from repro_torch.kernels.hdc_am.ops import am_search
    from repro_torch.kernels.hdc_encoder.ops import encoder
    from repro_torch.kernels.hdc_fleet.ops import fleet_counts_kernel
    from repro_torch.kernels.lbp.ops import lbp_codes

    return {"lbp": lbp_codes, "hdc_encoder": encoder, "hdc_am": am_search,
            "hdc_fleet": fleet_counts_kernel, "dense_hdc": dense_encoder}


@dataclass
class EntryAudit:
    """Audit result for one warm-up entry's program."""

    name: str
    kind: str
    expected_in_place: int | None    # state leaves that must be in place, or None
    in_place: int = 0                # leaves found in place
    written: list = field(default_factory=list)      # leaves an in-place op wrote
    not_in_place: dict = field(default_factory=dict)  # leaf -> why not
    kernels: list = field(default_factory=list)
    unexpected_kernels: list = field(default_factory=list)
    host_escapes: list = field(default_factory=list)
    dtype_histogram: dict = field(default_factory=dict)
    wide: list = field(default_factory=list)         # 64-bit findings
    explicit_i64: int = 0            # int64 tensors that passed rule (c)
    replayed: bool = False
    seconds: float = 0.0             # the entry's audit, body and replay
    errors: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    @property
    def problems(self) -> list:
        out = list(self.errors)
        if self.not_in_place:
            out.append("state not written in place: " + "; ".join(
                f"{k}: {v}" for k, v in self.not_in_place.items()))
        if self.expected_in_place is not None and self.in_place < self.expected_in_place:
            out.append(f"state written in place: {self.in_place}/"
                       f"{self.expected_in_place} leaves")
        if self.host_escapes:
            out.append("host escapes in the program: "
                       + ", ".join(sorted(set(self.host_escapes))))
        if self.unexpected_kernels:
            out.append("kernel launches the capture does not hold: "
                       + ", ".join(sorted(set(self.unexpected_kernels))))
        if self.wide:
            out.append("64-bit widening in the packed path: " + ", ".join(self.wide))
        return out

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "ok": self.ok,
                "expected_in_place": self.expected_in_place, "in_place": self.in_place,
                "written": list(self.written), "kernels": list(self.kernels),
                "host_escapes": sorted(set(self.host_escapes)),
                "dtype_histogram": dict(sorted(self.dtype_histogram.items())),
                "explicit_i64": self.explicit_i64, "replayed": self.replayed,
                "seconds": self.seconds, "problems": self.problems}


@dataclass
class AuditReport:
    entries: list
    device: str

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.entries)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "device": self.device,
                "entries": [e.to_dict() for e in self.entries]}


class _Recorder(TorchDispatchMode):
    """Sees every operator a body dispatches: host escapes, in-place
    writes (by storage), dtypes and 64-bit findings.  Inside a kernel's
    plain version (``opaque``) it only passes operators on."""

    def __init__(self, audit: EntryAudit, storages: dict):
        super().__init__()
        self.audit = audit
        self.storages = storages      # storage data_ptr -> state leaf name
        self.opaque = 0

    def _escape(self, what: str) -> None:
        self.audit.host_escapes.append(f"{what} at {_source()}")

    def _results(self, op: str, out, inputs: list, explicit: bool, narrower: bool) -> None:
        """Count ``out``'s tensors; an int64 one fails unless ``explicit`` or
        made from int64 operands with no ``narrower`` buffer among them."""
        in_i64 = any(t.dtype == torch.int64 for t in inputs)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.numel() <= 1:
                continue
            key = _elem(t.dtype)
            self.audit.dtype_histogram[key] = self.audit.dtype_histogram.get(key, 0) + 1
            if t.dtype in _WIDE_FLOATS:
                self.audit.wide.append(f"{op} -> {key}{list(t.shape)} at {_source()}")
            elif t.dtype == torch.int64:
                if explicit or (in_i64 and not narrower):
                    self.audit.explicit_i64 += 1
                else:
                    self.audit.wide.append(
                        f"{op} -> i64{list(t.shape)} from "
                        f"{'/'.join(sorted({_elem(x.dtype) for x in inputs})) or 'no tensor'}"
                        f" at {_source()}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.opaque:
            return func(*args, **kwargs)
        packet = func.overloadpacket
        flat = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        if packet in _HOST_ESCAPES:
            self._escape(str(packet).replace("aten.", "aten::"))
        elif (packet is aten.repeat_interleave and func is not aten.repeat_interleave.self_int
              and kwargs.get("output_size") is None):   # the repeats read back
            self._escape("aten::repeat_interleave without output_size")
        elif packet in (aten.copy_, aten._to_copy):
            dst = args[0].device if packet is aten.copy_ else kwargs.get("device")
            src = (args[1] if packet is aten.copy_ else args[0]).device
            if dst is not None and _other_device(torch.device(dst), src):
                self._escape(f"copy {src} -> {dst}")
        writes = narrower = False
        for i, arg in enumerate(func._schema.arguments):
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            if arg.alias_info is not None and arg.alias_info.is_write:
                if isinstance(val, torch.Tensor):   # the result keeps its dtype
                    writes = True
                    leaf = self.storages.get(val.untyped_storage().data_ptr())
                    if leaf is not None and leaf not in self.audit.written:
                        self.audit.written.append(leaf)
            elif arg.name not in _INDEX_ARGS:
                narrower = narrower or any(_narrower(t) for t in tree_flatten(val)[0])
        out = func(*args, **kwargs)
        self._results(str(packet).replace("aten.", ""), out, flat,
                      packet in _EXPLICIT or writes, narrower)
        return out

    def kernel(self, name, fn, args, kwargs):
        """The observer of ``kernels/common.py::plain``: one opaque
        operation."""
        self.audit.kernels.append(name)
        self.opaque += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.opaque -= 1
        inputs = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        self._results(f"kernel {name}", out, inputs, False, any(map(_narrower, inputs)))
        return out


@contextlib.contextmanager
def _host_reads(rec: _Recorder):
    """On the CPU: record the host reads of a tensor that dispatch does not
    show (``numpy``, ``tolist``, ``__array__``)."""
    saved = {name: torch.Tensor.__dict__.get(name) for name in _HOST_READS}

    def reader(name, orig):
        def method(self, *args, **kwargs):
            if not rec.opaque and not getattr(self, "_host_staging", False):
                rec._escape(f"Tensor.{name}")
            return orig(self, *args, **kwargs)
        return method

    try:
        for name in _HOST_READS:
            setattr(torch.Tensor, name, reader(name, getattr(torch.Tensor, name)))
        yield
    finally:
        for name, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)


def _run_body(program: graphs.Program, audit: EntryAudit, cuda: bool) -> tuple | None:
    """The body once under the recorder; its outputs, or None when the
    card refused a host sync in it (anything else it raises propagates)."""
    storages = {t.untyped_storage().data_ptr(): name for name, t in program.state.items()}
    rec = _Recorder(audit, storages)
    wrappers = _wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    prev_sync = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        with contextlib.ExitStack() as stack:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            else:
                stack.enter_context(_host_reads(rec))
            stack.enter_context(common.observe_plain(rec.kernel))
            stack.enter_context(rec)
            outputs = tuple(program.body())
    except RuntimeError as ex:
        if "synchronizing" not in str(ex):
            raise
        # set_sync_debug_mode("error") refused a host sync: the entry fails
        audit.errors.append(f"the body raised {type(ex).__name__}: {ex}")
        return None
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev_sync)
    for name, w in wrappers.items():
        audit.kernels.extend([name] * (w.launches - before[name]))
    held = {name for name, w in wrappers.items() if w in program.counted}
    audit.unexpected_kernels = [k for k in audit.kernels if k not in held]
    return outputs


def _check_state(program: graphs.Program, audit: EntryAudit, ptrs: dict,
                 expected: dict | None, passed: set, what: str) -> int:
    """Leaves in place after a body run or a replay; records why the others
    are not.  Returns the count."""
    n = 0
    for name, t in program.state.items():
        if t.untyped_storage().data_ptr() != ptrs[name]:
            audit.not_in_place[name] = f"{what} moved it to another storage"
        elif expected is not None and not torch.equal(t, expected[name]):
            audit.not_in_place[name] = (f"{what} left it unequal to the eager step's "
                                        "(rebound instead of copied?)")
        elif name not in audit.written and name not in passed:
            audit.not_in_place[name] = f"{what} never wrote it in place"
        else:
            n += 1
    return n


def audit_entry(program: graphs.Program, *, expected_in_place: int | None = None,
                graph: graphs.StepGraph | None = None, pool=None) -> EntryAudit:
    """Audit one program (a ``graphs.Program``): its body once
    under the recorder and, on the card, its CUDA graph replayed once (the
    ``graph`` given, else one captured here into ``pool``).  The state
    leaves are put back as they were before the audit."""
    tensors = [*program.state.values(), *program.inputs.values()]
    cuda = any(t.is_cuda for t in tensors)
    audit = EntryAudit(name=program.name, kind=program.kind,
                       expected_in_place=expected_in_place)
    t0 = time.perf_counter()
    with torch.cuda.device(next(t for t in tensors if t.is_cuda)) if cuda \
            else contextlib.nullcontext():
        _audit(program, audit, graph, pool, cuda)
    audit.seconds = time.perf_counter() - t0
    return audit


def _audit(program, audit, graph, pool, cuda) -> None:
    snapshot = {k: t.clone() for k, t in program.state.items()}
    ptrs = {k: t.untyped_storage().data_ptr() for k, t in program.state.items()}
    expected, passed = None, set()
    if program.eager is not None:
        copies = {k: t.clone() for k, t in program.state.items()}
        expected = program.eager(dict(copies))
        passed = {k for k, t in expected.items() if t is copies[k]}
    if cuda:
        program.warm()      # loads the kernel library and lazy constants
        torch.cuda.synchronize()
    outputs = _run_body(program, audit, cuda)
    try:
        if outputs is None:
            return
        if cuda:
            torch.cuda.synchronize()
        audit.in_place = _check_state(program, audit, ptrs, expected, passed, "the body")
        if cuda:
            outputs = tuple(t.clone() for t in outputs)
            if graph is None:
                graph = graphs.capture_program(
                    program, pool if pool is not None else torch.cuda.graph_pool_handle())
            for k, t in program.state.items():
                t.copy_(snapshot[k])
            out_ptrs = [t.data_ptr() for t in graph.outputs]
            got = graph.replay()
            torch.cuda.synchronize()
            audit.replayed = True
            if got is not graph.outputs or [t.data_ptr() for t in got] != out_ptrs:
                audit.errors.append("the replay did not return its static outputs")
            elif len(got) != len(outputs) or not all(
                    torch.equal(a, b) for a, b in zip(got, outputs)):
                audit.errors.append("the replay's outputs differ from the body's")
            _check_state(program, audit, ptrs, expected, passed, "the replay")
    finally:
        for k, t in program.state.items():
            t.copy_(snapshot[k])


# ---------------------------------------------------------------------------
# the program sets: the reference's tiny fleet + engine, or a live fleet
# ---------------------------------------------------------------------------

def _expected(program: graphs.Program) -> int | None:
    """A step writes its whole state (the reference's donated ``FleetState``);
    adapt and the engine are not held to a count, as in the reference."""
    return len(program.state) if program.kind == "step" else None


def _tiny_programs(device):
    """The reference's program set (``hlo_audit._tiny_programs``): a bank of
    one pipeline trained one-shot on a seeded draw at D = 256, 8 segments,
    8 channels, window 32 (``sparse_compim``, spatial threshold 1,
    temporal 4); a two-session fleet at bucket 32 with one round pushed
    (so the step emits and the adapt's gate can fire) and seeded inputs;
    the engine at batch buckets 1 and 2.  Returns (program, expected,
    graph) triples."""
    from repro_torch.core.pipeline import HDCConfig, HDCPipeline
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.fleet import StreamingFleet

    dim, segments, channels, window = 256, 8, 8, 32
    cfg = HDCConfig(dim=dim, segments=segments, channels=channels, window=window,
                    variant="sparse_compim", spatial_threshold=1, temporal_threshold=4)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 64, (2, 4 * window, channels), np.uint8)
    labels = rng.integers(0, 2, (2, 4), np.int32)
    labels[0, :2] = (0, 1)
    pipe = HDCPipeline.init(torch.Generator().manual_seed(0), cfg, device=device)
    pipe = pipe.train_one_shot(codes, torch.as_tensor(labels, device=device))

    fleet = StreamingFleet({"p": pipe}, ["p"] * 2, buckets=(window,))
    fleet.push([c[:window + 8] for c in codes])
    out = []
    for prog, graph in fleet.programs():
        if prog.kind == "step":
            prog.inputs["codes"].copy_(torch.from_numpy(
                rng.integers(0, 64, tuple(prog.inputs["codes"].shape), np.uint8)))
            prog.inputs["lengths"].copy_(torch.tensor([window, window - 12], dtype=torch.int32))
        else:
            prog.inputs["labels"].copy_(torch.tensor([1, 0]))
        out.append((prog, _expected(prog), graph))
    engine = ServingEngine({"p": pipe})
    for entry in engine.aot_entries([1, 2], window):
        prog = engine._dispatch_program(entry.tile, entry.bucket)
        prog.inputs["codes"].copy_(torch.from_numpy(
            rng.integers(0, 64, tuple(prog.inputs["codes"].shape), np.uint8)))
        out.append((prog, None, None))
    return out


def _audit_programs(triples) -> AuditReport:
    """Audit (program, expected, graph) triples; one graph pool for the
    captures made here."""
    triples = list(triples)
    cuda = any(t.is_cuda for p, _, _ in triples
               for t in (*p.state.values(), *p.inputs.values()))
    pool = torch.cuda.graph_pool_handle() if cuda else None
    entries = [audit_entry(p, expected_in_place=e, graph=g, pool=pool)
               for p, e, g in triples]
    return AuditReport(entries=entries, device="cuda" if cuda else "cpu")


def audit_fleet(fleet) -> AuditReport:
    """Audit a live fleet's programs (``StreamingFleet.programs``; an
    ``ElasticFleet``'s every tile): on a warmed fleet each step and adapt
    is replayed from the graph it captured.  The fleet's state is left as
    it was."""
    return _audit_programs((p, _expected(p), g) for p, g in fleet.programs())


def run_audit(*, device=None) -> AuditReport:
    """Audit the reference's program set (``_tiny_programs``) on ``device``
    (default: the card, raising without one; ``"cpu"`` runs the plain
    path).  On the card each entry is also captured and replayed."""
    from repro_torch.device import resolve_device

    return _audit_programs(_tiny_programs(resolve_device(device)))
