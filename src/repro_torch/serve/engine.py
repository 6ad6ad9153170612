"""Batched serving and streaming sessions (port of ``repro.serve.engine``).

* ``ServingEngine`` serves a batch of ``(patient_id, codes)`` requests
  against a bank of trained per-patient pipelines in one padded dispatch:
  the patients' pre-bound codebooks and class HVs are stacked at
  construction and each request gathers its rows, so any mix of patients
  is one batch.  Batch sizes pad to powers of two, as in the reference.
* ``SeizureSession`` is one patient's stream: ``push`` takes chunks of any
  length and carries the temporal accumulator across calls, emitting one
  decision per completed window; ``adapt`` applies the gated online update
  (``core/online.py``) to the session's own AM; ``snapshot`` /
  ``from_snapshot`` carry its whole state across a reconnect in the
  reference's ``.npz`` wire format (``SessionSnapshot``).

Both count their frames through the fleet kernel (``kernels/hdc_fleet``),
whose wrapper dispatches on the device of the codes (the bank's or the
pipeline's device): the CUDA kernel on the card, its plain version on the
CPU.  The engine runs each (request, frame) as one session of ``window``
cycles, and a session runs as a fleet of one, split into pieces of at most
``SESSION_PIECE`` cycles, so that its frame slots fit in the kernel's shared
memory; frames are scored by the AM kernel (session) or by owner-gathered
scoring (engine).

``ServingEngine.prewarm`` captures the dispatch of every power-of-two
batch bucket up to a batch size, at one request length, as a CUDA graph
(``runtime/graphs.py``; the reference's AOT executables); ``serve``
replays the graph of a prewarmed (padded batch, length) and runs eagerly
otherwise.  ``serve`` and ``SeizureSession.push`` return host values, so
their uploads need not be asynchronous.
"""

from __future__ import annotations

import hashlib
import io
import json
from dataclasses import dataclass
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import am, hv, online
from repro_torch.core.pipeline import HDCConfig, HDCPipeline, _am_mode
from repro_torch.kernels.hdc_am.ops import am_search
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.runtime import aot as aot_mod
from repro_torch.runtime import graphs
from repro_torch.serve import dispatch

# the longest piece of a session's chunk one fleet-kernel launch counts: the
# fleet's largest bucket, whose frame slots (K + 1 rows of D counters) fit in
# the kernel's shared memory at the paper's geometry
SESSION_PIECE = 256


def _pack_frames(counts: torch.Tensor, thresholds, cfg: HDCConfig) -> torch.Tensor:
    """Temporal counts (..., D) -> packed frames (..., W): the threshold
    (sparse; ``thresholds`` broadcast against the leading dims) or the
    window majority (dense)."""
    if cfg.variant == "dense":
        return hv.majority_pack(counts, cfg.window, cfg.dim)
    return hv.threshold_pack(counts, thresholds)


def _frame_sessions(tables: torch.Tensor, param_owner: torch.Tensor,
                    thresholds: torch.Tensor, codes: torch.Tensor,
                    cfg: HDCConfig) -> torch.Tensor:
    """(B, F * window, channels) codes -> (B, F, W) frames
    through the fleet kernel: each (request, frame) is one session of
    ``window`` cycles starting empty, its codes a view of the batch."""
    b, t, c = codes.shape
    f = t // cfg.window
    s = b * f
    dev = codes.device
    seg = fleet_ops.fleet_counts_fused(
        tables, param_owner.repeat_interleave(f, output_size=s),
        codes.reshape(s, cfg.window, c),
        torch.zeros((s,), dtype=torch.int32, device=dev),
        torch.full((s,), cfg.window, dtype=torch.int32, device=dev), cfg)
    # output_size: the repeats read no device value back
    frames = _pack_frames(seg[:, 0],
                          thresholds.repeat_interleave(f, output_size=s)[:, None], cfg)
    return frames.reshape(b, f, cfg.words)


def _serve_dispatch(tables, class_bank, param_owner, owner, thresholds,
                    codes, cfg: HDCConfig):
    """One padded batch: encode + gathered AM scoring + argmax.  codes
    (B_pad, F * window, channels); owner (B_pad,) rows of the class bank;
    param_owner (B_pad,) rows of the stacked pre-bound tables; thresholds
    (B_pad,) each request's temporal threshold."""
    frames = _frame_sessions(tables, param_owner, thresholds, codes, cfg)
    cls = class_bank[owner]                                       # (B, C, W)
    scores = dispatch.owner_am_scores(frames, cls[:, None], cfg)  # (B, F, C)
    return frames, scores, am.am_predict(scores)


def _session_adapt(state: online.OnlineAMState, class_hvs: torch.Tensor,
                   frame_hv: torch.Tensor, scores: torch.Tensor, label: int,
                   margin: float, cfg: HDCConfig):
    """One gated online update for one session: the true label of its last
    frame; the class HVs are re-thresholded from the counter file when the
    gate fires.  Returns (state, class_hvs, applied)."""
    bits = hv.unpack_bits(frame_hv, cfg.dim)
    lab = torch.full((), label, dtype=torch.int64, device=scores.device)
    new_state, applied = online.update(state, bits, lab, scores, margin=margin)
    chvs = online.class_hvs_from_state(new_state, cfg)
    return new_state, torch.where(applied, chvs, class_hvs), applied


@dataclass(frozen=True)
class Decision:
    """Result for one request: per-frame scores and predictions, and the
    frame HVs."""
    request_id: int
    patient_id: Hashable
    scores: np.ndarray       # (F, n_classes) int32
    predictions: np.ndarray  # (F,) int32; 1 = ictal for the 2-class system
    frames: np.ndarray       # (F, W) uint32 packed frame HVs


def _shape(codes) -> tuple:
    return tuple(codes.shape) if hasattr(codes, "shape") else np.shape(codes)


class ServingEngine:
    """Batched serving over a bank of trained per-patient pipelines (one
    shared datapath, ``dispatch.datapath_key``; each patient keeps its own
    calibrated ``temporal_threshold`` and codebooks), on the bank's
    device."""

    def __init__(self, pipelines: Mapping[Hashable, HDCPipeline]):
        if not pipelines:
            raise ValueError("ServingEngine needs at least one pipeline")
        self._pipelines = dict(pipelines)
        self._cfg = dispatch.validate_bank(self._pipelines)
        self._pids = list(self._pipelines)
        self._pid_index = {pid: i for i, pid in enumerate(self._pids)}
        pipes = [self._pipelines[pid] for pid in self._pids]
        dev = self._device = pipes[0].device
        tables, param_rows = dispatch.stack_bound_tables(pipes)
        self._tables = tables.contiguous()
        self._param_rows = torch.as_tensor(param_rows, device=dev)
        self._bank = torch.stack([p.class_hvs for p in pipes])      # (P, C, W)
        self._thresholds = torch.as_tensor(
            np.asarray([p.cfg.temporal_threshold for p in pipes], np.int32),
            device=dev)
        # prewarm: (b_pad, t) -> the captured dispatch and its static inputs
        self._graphs: dict[tuple[int, int], tuple] = {}
        self._pool = None
        self._shapes_seen: set[tuple[int, int]] = set()

    @property
    def patient_ids(self) -> list:
        return list(self._pids)

    @property
    def aot_count(self) -> int:
        """Dispatches captured by ``prewarm``."""
        return len(self._graphs)

    def _aot_sig(self) -> str:
        h = hashlib.sha256()
        h.update(repr(self._cfg).encode())
        h.update(self._device.type.encode())
        h.update(str(tuple(self._tables.shape)).encode())
        h.update(str(tuple(self._bank.shape)).encode())
        return h.hexdigest()[:10]

    def _aot_name(self, b_pad: int, t: int) -> str:
        return f"engine.{self._cfg.variant}.b{b_pad}.t{t}.{self._aot_sig()}"

    @staticmethod
    def _pow2_buckets(max_batch: int) -> list[int]:
        top = 1 << (max(1, int(max_batch)) - 1).bit_length()
        return [1 << i for i in range(top.bit_length())]

    def aot_entries(self, batch_sizes: Sequence[int], t: int
                    ) -> list[aot_mod.AOTEntry]:
        """Entries for the dispatch at the power-of-two batch buckets that
        cover ``batch_sizes``, at request length ``t``."""
        buckets = sorted({1 << (max(1, int(b)) - 1).bit_length()
                          for b in batch_sizes})
        return [aot_mod.AOTEntry(self._aot_name(b, t), "engine", b, t)
                for b in buckets]

    def prewarm(self, max_batch: int, t: int, *,
                aot: aot_mod.AOTArtifact | None = None) -> dict[str, int]:
        """Capture the dispatch of every power-of-two batch bucket up to
        ``max_batch`` at request length ``t`` as a CUDA graph (the kernel
        library from ``aot`` when given); each capture first runs the
        dispatch eagerly.  An entry named in ``aot`` counts as ``loaded``,
        any other capture as ``compiled``; on the CPU every bucket is
        ``skipped``.  Returns ``{"loaded", "compiled", "skipped"}``."""
        stats = {"loaded": 0, "compiled": 0, "skipped": 0}
        buckets = self._pow2_buckets(max_batch)
        if self._device.type != "cuda":
            stats["skipped"] = len(buckets)
            return stats
        aot_mod.load_library(aot)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        for b_pad in buckets:
            if (b_pad, t) in self._graphs:
                stats["skipped"] += 1
                continue
            prog = self._dispatch_program(b_pad, t)
            g = graphs.capture_program(prog, self._pool)
            self._graphs[(b_pad, t)] = (g, prog.inputs["owner"], prog.inputs["codes"])
            stats["loaded" if aot is not None and prog.name in aot else "compiled"] += 1
        return stats

    def _dispatch_program(self, b_pad: int, t: int) -> graphs.Program:
        """The dispatch of a padded batch of ``b_pad`` requests of ``t``
        cycles over fresh static inputs (the owners and the codes): what
        ``prewarm`` captures and the audit (``analysis/audit.py``) reads.
        The engine keeps no state, so the program writes none."""
        cfg, dev = self._cfg, self._device
        own = torch.zeros((b_pad,), dtype=torch.int64, device=dev)
        codes = torch.zeros((b_pad, t // cfg.window * cfg.window, cfg.channels),
                            dtype=torch.uint8, device=dev)

        def body():
            return _serve_dispatch(self._tables, self._bank, self._param_rows[own], own,
                                   self._thresholds[own], codes, cfg)

        return graphs.Program(name=self._aot_name(b_pad, t), kind="engine", body=body,
                              inputs={"owner": own, "codes": codes},
                              counted=(fleet_ops.fleet_counts_kernel,))

    @property
    def device(self) -> torch.device:
        return self._device

    def serve(self, requests: Sequence[tuple[Hashable, np.ndarray]]
              ) -> list[Decision]:
        """Serve one batch of ``(patient_id, codes)`` requests: ``codes``
        (T, channels) uint8 LBP codes, one T across the batch, T >= window
        (sub-window chunks belong to ``SeizureSession``); cycles past the
        last full window are dropped, as in ``encode_frames``.  Returns one
        Decision per request, in request order."""
        if not requests:
            return []
        pids, codes = zip(*requests)
        for pid in pids:
            if pid not in self._pid_index:
                raise KeyError(f"unknown patient id {pid!r}")
        shapes = {_shape(c) for c in codes}
        if len(shapes) > 1:
            raise ValueError(f"all requests in a batch must share one codes "
                             f"shape; got {sorted(shapes)}")
        t = next(iter(shapes))[0]
        cfg = self._cfg
        if t < cfg.window:
            raise ValueError(
                f"request codes span {t} cycles < one {cfg.window}-cycle "
                "window, which would yield zero frames; use SeizureSession "
                "for sub-window streaming chunks")
        # pad the batch to a power of two (padded rows replay patient row 0
        # on zero codes), as the reference does
        b = len(requests)
        b_pad = 1 << (b - 1).bit_length()
        t_used = t // cfg.window * cfg.window
        owner = np.zeros((b_pad,), np.int64)
        owner[:b] = [self._pid_index[pid] for pid in pids]
        batch = np.zeros((b_pad, t_used, cfg.channels), np.uint8)
        for i, c in enumerate(codes):
            batch[i] = np.asarray(c)[:t_used]
        warm = self._graphs.get((b_pad, t))
        if warm is not None:
            graph, own, codes_t = warm
            own.copy_(torch.from_numpy(owner))
            codes_t.copy_(torch.from_numpy(batch))
            frames, scores, preds = graph.replay()
        else:
            if (b_pad, t) not in self._shapes_seen:
                self._shapes_seen.add((b_pad, t))
                graphs.EAGER_LOG.append(self._aot_name(b_pad, t))
            own = torch.from_numpy(owner).to(self._device)
            frames, scores, preds = _serve_dispatch(
                self._tables, self._bank, self._param_rows[own], own,
                self._thresholds[own], torch.from_numpy(batch).to(self._device),
                cfg)
        frames_np = hv.to_u32(frames)
        scores_np, preds_np = scores.cpu().numpy(), preds.cpu().numpy()
        return [Decision(request_id=i, patient_id=pid, scores=scores_np[i],
                         predictions=preds_np[i], frames=frames_np[i])
                for i, pid in enumerate(pids)]


# ---------------------------------------------------------------------------
# streaming sessions
# ---------------------------------------------------------------------------

@dataclass
class FrameDecision:
    frame_index: int
    scores: np.ndarray        # (n_classes,) int32
    prediction: int           # argmax class id
    frame_hv: np.ndarray      # (W,) uint32 packed


@dataclass(frozen=True)
class SessionSnapshot:
    """Host-side capture of one streaming session's whole state: the
    mid-window accumulator, the (adapted) AM and its counter file, and the
    last emitted frame (so ``adapt`` feedback survives a reconnect).
    ``channel_mask`` carries an electrode quarantine where a fleet has one
    and stays None otherwise, so blobs without it load.

    ``to_bytes``/``from_bytes`` use the reference's compressed ``.npz``
    fields and dtypes (packed words as uint32), so either package resumes
    the other's snapshots; the patient id must be JSON-representable."""

    patient_id: Hashable
    counts: np.ndarray             # (D,) int32 temporal accumulator
    filled: int                    # cycles toward the next frame (< window)
    frame_index: int               # frames emitted so far
    class_rows: np.ndarray         # (C, W) uint32 (possibly adapted) AM
    am_counts: np.ndarray | None   # (C, D) int32 online counter file
    am_n: np.ndarray | None        # (C,) int32 frames bundled per class
    last_frame: np.ndarray         # (W,) uint32 last emitted frame HV
    last_scores: np.ndarray        # (C,) int32 its AM scores
    has_frame: int                 # 1 once a frame has been emitted
    channel_mask: np.ndarray | None = None  # (channels,) uint8 live mask

    def to_bytes(self) -> bytes:
        arrays = {
            "counts": np.asarray(self.counts, np.int32),
            "class_rows": np.asarray(self.class_rows, np.uint32),
            "last_frame": np.asarray(self.last_frame, np.uint32),
            "last_scores": np.asarray(self.last_scores, np.int32),
            "scalars": np.asarray(
                [self.filled, self.frame_index, self.has_frame,
                 int(self.am_counts is not None)], np.int64),
            "pid": np.frombuffer(
                json.dumps(self.patient_id).encode(), np.uint8),
        }
        if self.am_counts is not None:
            arrays["am_counts"] = np.asarray(self.am_counts, np.int32)
            arrays["am_n"] = np.asarray(self.am_n, np.int32)
        if self.channel_mask is not None:
            arrays["channel_mask"] = np.asarray(self.channel_mask, np.uint8)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SessionSnapshot":
        with np.load(io.BytesIO(blob)) as d:
            filled, fidx, has_frame, has_am = (int(x) for x in d["scalars"])
            return cls(
                patient_id=json.loads(bytes(d["pid"]).decode()),
                counts=d["counts"], filled=filled, frame_index=fidx,
                class_rows=d["class_rows"],
                am_counts=d["am_counts"] if has_am else None,
                am_n=d["am_n"] if has_am else None,
                last_frame=d["last_frame"], last_scores=d["last_scores"],
                has_frame=has_frame,
                channel_mask=(d["channel_mask"]
                              if "channel_mask" in d.files else None))


class SeizureSession:
    """Stateful streaming detector for one patient, on its pipeline's
    device.  ``push`` takes chunks of any length (sub-window,
    window-crossing, multi-window) and returns the decisions they complete;
    chunked pushes are bit-exact with one ``encode_frames`` of the whole
    stream.  ``adapt(label)`` feeds back the true label of the last emitted
    frame and updates this session's AM; the pipeline stays unchanged.
    ``serve.fleet.StreamingFleet`` is bit-exact with this class, ``adapt``
    included, and advances many streams at once."""

    def __init__(self, pipeline: HDCPipeline):
        if pipeline.class_hvs is None:
            raise ValueError("SeizureSession needs a trained pipeline")
        self._pipe = pipeline
        cfg = pipeline.cfg
        self._counts = torch.zeros((cfg.dim,), dtype=torch.int32,
                                   device=pipeline.device)
        self._filled = 0
        self._frame_index = 0
        # per-session adaptive AM: seeded from the pipeline, updated by adapt
        self._class_hvs = pipeline.class_hvs
        self._online = pipeline.am_state
        self._last: FrameDecision | None = None
        self._table: torch.Tensor | None = None   # the kernel's bound table

    @property
    def cycles_buffered(self) -> int:
        """Cycles accumulated toward the next (incomplete) frame."""
        return self._filled

    @property
    def class_hvs(self) -> torch.Tensor:
        """This session's (possibly adapted) (C, W) class HVs."""
        return self._class_hvs

    @property
    def am_state(self) -> online.OnlineAMState | None:
        """This session's (possibly adapted) AM counter file."""
        return self._online

    def adapt(self, label: int, *, margin: float = 0.0) -> bool:
        """Online update from the true label of the last emitted frame.
        Returns True when the gated update fired (prediction wrong, or its
        lead over the rival class below ``margin``); the session's class
        HVs are then re-thresholded from its counter file."""
        if self._last is None:
            raise ValueError("no frame emitted yet; adapt() labels the most "
                             "recent decision")
        if self._online is None:
            raise ValueError(
                "pipeline carries no am_state counter file; train it with "
                "train_one_shot or fit_iterative before adapting")
        cfg = self._pipe.cfg
        if not 0 <= label < cfg.n_classes:
            raise ValueError(f"label {label} not in [0, {cfg.n_classes})")
        dev = self._pipe.device
        self._online, self._class_hvs, applied = _session_adapt(
            self._online, self._class_hvs,
            torch.from_numpy(hv.to_i32(self._last.frame_hv)).to(dev),
            torch.from_numpy(np.asarray(self._last.scores, np.int32)).to(dev),
            int(label), margin, cfg)
        return bool(applied)

    def snapshot(self, patient_id: Hashable = None) -> SessionSnapshot:
        """This session's whole streaming state as a ``SessionSnapshot``
        (the session is untouched)."""
        cfg = self._pipe.cfg
        last = self._last
        return SessionSnapshot(
            patient_id=patient_id,
            counts=self._counts.cpu().numpy().astype(np.int32),
            filled=int(self._filled),
            frame_index=int(self._frame_index),
            class_rows=hv.to_u32(self._class_hvs),
            am_counts=(self._online.counts.cpu().numpy()
                       if self._online is not None else None),
            am_n=(self._online.n.cpu().numpy()
                  if self._online is not None else None),
            last_frame=(np.asarray(last.frame_hv, np.uint32)
                        if last is not None
                        else np.zeros((cfg.words,), np.uint32)),
            last_scores=(np.asarray(last.scores, np.int32)
                         if last is not None
                         else np.zeros((cfg.n_classes,), np.int32)),
            has_frame=int(last is not None))

    @classmethod
    def from_snapshot(cls, pipeline: HDCPipeline,
                      snap: SessionSnapshot) -> "SeizureSession":
        """Rebuild a session from a ``snapshot()`` against the same trained
        pipeline, on the pipeline's device."""
        sess = cls(pipeline)
        dev = pipeline.device

        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(dev)

        sess._counts = put(snap.counts, np.int32)
        sess._filled = int(snap.filled)
        sess._frame_index = int(snap.frame_index)
        sess._class_hvs = torch.from_numpy(hv.to_i32(snap.class_rows)).to(dev)
        if snap.am_counts is not None:
            sess._online = online.OnlineAMState(
                counts=put(snap.am_counts, np.int32), n=put(snap.am_n, np.int32))
        if snap.has_frame:
            scores = np.asarray(snap.last_scores, np.int32)
            sess._last = FrameDecision(
                frame_index=int(snap.frame_index) - 1,
                scores=scores, prediction=int(np.argmax(scores)),
                frame_hv=np.asarray(snap.last_frame, np.uint32))
        return sess

    def _count(self, codes: torch.Tensor) -> list[torch.Tensor]:
        """The fleet kernel on a fleet of one session, a launch per
        ``SESSION_PIECE`` cycles, carrying ``filled`` and the tail counts as
        the fleet step does; returns the completed frames' counts."""
        cfg = self._pipe.cfg
        dev = codes.device
        if self._table is None:
            self._table = dispatch.bound_table(
                self._pipe.params, dispatch.datapath_key(cfg))[None].contiguous()
        owner = torch.zeros((1,), dtype=torch.int32, device=dev)
        done = []
        for pos in range(0, codes.shape[0], SESSION_PIECE):
            piece = codes[pos:pos + SESSION_PIECE]
            n = piece.shape[0]
            seg = fleet_ops.fleet_counts_fused(
                self._table, owner, piece[None],
                torch.full((1,), self._filled, dtype=torch.int32, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev), cfg)[0]
            n_emit = (self._filled + n) // cfg.window
            if n_emit:
                # the carried counts belong to the first completed frame
                done.append(seg[0] + self._counts)
                done.extend(seg[1:n_emit])
                self._counts = seg[-1]
            else:
                self._counts = self._counts + seg[-1]
            self._filled += n - n_emit * cfg.window
        return done

    def push(self, codes) -> list[FrameDecision]:
        """Feed (t, channels) integer codes; returns the decisions of every
        frame this chunk completes (possibly none).  Codes are validated at
        the ingest boundary: shape, integer dtype and the item-memory
        alphabet."""
        cfg = self._pipe.cfg
        host = (codes.cpu().numpy() if isinstance(codes, torch.Tensor)
                else np.asarray(codes))
        if host.ndim != 2 or host.shape[1] != cfg.channels:
            raise ValueError(
                f"push needs a (t, {cfg.channels}) code chunk, got "
                f"{host.shape}")
        if not np.issubdtype(host.dtype, np.integer):
            raise ValueError(
                f"push needs integer LBP codes, got dtype {host.dtype} "
                "(run raw signal through data.ieeg.lbp_codes_np first; "
                "it rejects NaN/Inf and clamps ADC rails)")
        if host.size and (host.min() < 0 or host.max() >= cfg.codes):
            bad = host[(host < 0) | (host >= cfg.codes)][0]
            raise ValueError(
                f"code {int(bad)} outside the item-memory alphabet "
                f"[0, {cfg.codes}); corrupt ingest would silently clamp "
                "into the wrong codebook rows")
        if host.shape[0] == 0:
            return []
        chunk = torch.from_numpy(host.astype(np.uint8)).to(self._pipe.device)
        done = self._count(chunk)
        if not done:
            return []
        frames = _pack_frames(torch.stack(done), cfg.temporal_threshold, cfg)
        scores = am_search(frames, self._class_hvs, mode=_am_mode(cfg),
                           dim=cfg.dim)
        frames_np, scores_np = hv.to_u32(frames), scores.cpu().numpy()
        out = []
        for k in range(len(done)):
            out.append(FrameDecision(
                frame_index=self._frame_index, scores=scores_np[k],
                prediction=int(np.argmax(scores_np[k])), frame_hv=frames_np[k]))
            self._frame_index += 1
        self._last = out[-1]
        return out
