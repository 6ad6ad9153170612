"""Streaming fleet: S concurrent sessions advanced by one device step
(port of the core of ``repro.serve.fleet.StreamingFleet``).

The fleet keeps S sessions in one device-resident ``FleetState``:

* ``counts``      (S, D) int32 — the stacked temporal accumulators,
* ``filled``      (S,)   int32 — cycles accumulated toward each next frame,
* ``frame_index`` (S,)   int32 — frames emitted so far,

plus each session's class rows, its online counter file (``am_counts``,
``am_n``) and its last emitted frame and scores.  One
step advances all sessions over a padded (S, t_pad, channels) uint8 code
batch: the fused fleet kernel gathers the pre-bound rows, bundles them
(OR tree for ``sparse_compim``; adder tree with thinning for
``spatial_thinning`` and ``sparse_naive``; channel majority for dense) and
counts every frame slot of the step (``kernels/hdc_fleet``); the carried
counts are added, frames are threshold-packed (dense: majority over the
window) and scored against the session's class rows (plain tensor code, as
in the reference).

Chunks may have any length per session (0 included).  Lengths are padded
to the smallest bucket that fits, and a chunk longer than the largest
bucket splits over several steps.  Ingest goes through a pinned host
staging buffer per (slot, bucket), copied with ``non_blocking=True`` and
double-buffered: a buffer is rewritten only after the step that read it
has finished (a CUDA event recorded after that step).  The host keeps O(S)
mirrors of ``filled``/``frame_index`` to route results without a sync;
pushes never wait for the device, ``collect_decisions`` does (and so do
``adapt``, ``save`` and ``restore``, which return host values).

``adapt`` applies one gated online update to every session at once (plain
torch, ``core/online.py``), and ``save``/``restore`` checkpoint the whole
state mid-stream (``ckpt/checkpoint.py``).

Decisions are bit-exact with the reference fleet.  Not ported yet: mesh
placement, session tiles, AOT warm-up, elastic slots, fault injection, ECC,
channel masking and stage probes.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, fields, replace
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import hv, online
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.serve import dispatch
from repro_torch.serve.engine import FrameDecision, _pack_frames

DEFAULT_BUCKETS = (32, 64, 128, 256)


@dataclass(frozen=True)
class FleetState:
    """Device state of all S sessions."""

    counts: torch.Tensor       # (S, D) int32 temporal accumulators
    filled: torch.Tensor       # (S,) int32 cycles toward each next frame
    frame_index: torch.Tensor  # (S,) int32 frames emitted so far
    class_rows: torch.Tensor   # (S, C, W) int32 per-session (adaptive) AM rows
    am_counts: torch.Tensor    # (S, C, D) int32 online counter-file bank
    am_n: torch.Tensor         # (S, C) int32 frames bundled per class
    last_frame: torch.Tensor   # (S, W) int32 last emitted frame HV
    last_scores: torch.Tensor  # (S, C) int32 its AM scores
    has_frame: torch.Tensor    # (S,) int32 1 once a session has emitted


# the leaves that hold packed words: checkpoints save them as uint32
_PACKED_LEAVES = ("class_rows", "last_frame")


@dataclass(frozen=True)
class FleetOut:
    """Raw step outputs: one row per potential frame slot (K per step)."""

    frames: torch.Tensor  # (S, K, W) int32 packed frame HVs
    scores: torch.Tensor  # (S, K, C) int32 AM scores


@dataclass(frozen=True)
class FleetRound:
    """One step's device outputs plus the host schedule to read them:
    ``(session, slot)`` with ``slot < n_emit[session]`` are real emissions
    with frame index ``frame_base[session] + slot``."""

    out: FleetOut
    n_emit: np.ndarray      # (S,) frames emitted this round
    frame_base: np.ndarray  # (S,) frame index of each session's slot 0


def _fleet_step(state: FleetState, tables: torch.Tensor, owner: torch.Tensor,
                thresholds: torch.Tensor, chunk: torch.Tensor,
                lengths: torch.Tensor, *, cfg: HDCConfig
                ) -> tuple[FleetState, FleetOut]:
    """Advance all S sessions by one padded chunk batch: chunk (S, t_pad,
    channels) uint8 raw codes, lengths (S,) int32 valid cycles."""
    s = chunk.shape[0]
    seg = fleet_ops.fleet_counts_fused(tables, owner, chunk, state.filled,
                                       lengths, cfg)      # (S, K+1, D)
    n_emit = torch.div(state.filled + lengths, cfg.window,
                       rounding_mode="floor")
    # the carried accumulator belongs to the FIRST completed frame when the
    # session emits, and to the tail otherwise
    emits = n_emit > 0
    frame_counts = seg[:, :-1].clone()
    frame_counts[:, 0] += torch.where(emits[:, None], state.counts, 0)
    frames = _pack_frames(frame_counts, thresholds[:, None, None], cfg)
    scores = dispatch.owner_am_scores(frames, state.class_rows[:, None], cfg)
    sidx = torch.arange(s, device=chunk.device)
    last_slot = torch.clamp(n_emit - 1, min=0).to(torch.int64)
    new_state = replace(
        state,
        counts=seg[:, -1] + torch.where(emits[:, None], 0, state.counts),
        filled=state.filled + lengths - n_emit * cfg.window,
        frame_index=state.frame_index + n_emit,
        last_frame=torch.where(emits[:, None], frames[sidx, last_slot],
                               state.last_frame),
        last_scores=torch.where(emits[:, None], scores[sidx, last_slot],
                                state.last_scores),
        has_frame=state.has_frame | emits.to(torch.int32),
    )
    return new_state, FleetOut(frames=frames, scores=scores)


def _fleet_adapt(state: FleetState, labels: torch.Tensor, margin: float,
                 density: torch.Tensor, *, cfg: HDCConfig
                 ) -> tuple[FleetState, torch.Tensor]:
    """One gated online update for all S sessions: labels (S,) the true
    class of each session's last emitted frame (-1 = no feedback), density
    (S,) float32 each session's ``class_density``.  Sessions whose gate
    fires get their counter files updated and their class rows
    re-thresholded; the others pass through unchanged.  Returns (state,
    applied (S,) bool)."""
    bits = hv.unpack_bits(state.last_frame, cfg.dim)            # (S, D)
    am = online.OnlineAMState(counts=state.am_counts, n=state.am_n)
    new_am, applied = online.update(am, bits, labels, state.last_scores,
                                    margin=margin, valid=state.has_frame > 0)
    chvs = online.class_hvs_from_state(new_am, cfg, density=density[:, None])
    class_rows = torch.where(applied[:, None, None], chvs, state.class_rows)
    return replace(state, am_counts=new_am.counts, am_n=new_am.n,
                   class_rows=class_rows), applied


class StreamingFleet:
    """S concurrent streaming seizure sessions advanced by one step.

    ``pipelines`` is the patient -> trained-pipeline bank (one shared
    datapath and device, any variant; per-patient codebooks and calibrated
    thresholds welcome).  ``owners[i]`` names the patient of session ``i``.  The fleet
    runs on the bank's device: the card, or the CPU for a bank built with
    ``device="cpu"``.
    """

    def __init__(self, pipelines: Mapping[Hashable, HDCPipeline],
                 owners: Sequence[Hashable], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self._cfg = dispatch.validate_bank(pipelines)
        if not owners:
            raise ValueError("StreamingFleet needs at least one session")
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        pids = list(pipelines)
        pid_index = {pid: i for i, pid in enumerate(pids)}
        for pid in owners:
            if pid not in pid_index:
                raise KeyError(f"unknown patient id {pid!r} in owners")
        pipes = [pipelines[pid] for pid in pids]
        self._device = pipes[0].device
        tables, param_rows = dispatch.stack_bound_tables(pipes)
        owner_idx = np.asarray([pid_index[pid] for pid in owners], np.int64)
        thresholds = np.asarray([p.cfg.temporal_threshold for p in pipes],
                                np.int32)
        density = np.asarray([p.cfg.class_density for p in pipes], np.float32)
        dev = self._device
        self._n = len(owner_idx)
        self._tables = tables.contiguous()
        self._owner = torch.as_tensor(param_rows[owner_idx], device=dev)
        self._thresholds = torch.as_tensor(thresholds[owner_idx], device=dev)
        self._density = torch.as_tensor(density[owner_idx], device=dev)
        sel = torch.as_tensor(owner_idx, device=dev)
        bank = torch.stack([p.class_hvs for p in pipes])      # (P, C, W)
        self._class_rows0 = bank[sel]
        # each session's AM starts from its patient's trained counter file;
        # a bank with a pipeline that has none cannot adapt
        if all(p.am_state is not None for p in pipes):
            self._am_counts0 = torch.stack([p.am_state.counts for p in pipes])[sel]
            self._am_n0 = torch.stack([p.am_state.n for p in pipes])[sel]
        else:
            self._am_counts0 = self._am_n0 = None
        self._state = self._zero_state()
        # host mirrors: the emission schedule is a function of (filled,
        # lengths), so the host routes results without reading the device
        self._filled_h = np.zeros((self._n,), np.int64)
        self._fidx_h = np.zeros((self._n,), np.int64)
        # (slot, bucket) -> staging buffer, and the event of the last step
        # that read it
        self._stage: dict[tuple[int, int], torch.Tensor] = {}
        self._stage_done: dict[tuple[int, int], torch.cuda.Event] = {}
        self._stage_phase = 0
        self._ragged_buf: np.ndarray | None = None

    # -- state ----------------------------------------------------------------

    def _zero_state(self) -> FleetState:
        cfg, dev, s = self._cfg, self._device, self._n
        c = self._class_rows0.shape[1]
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        if self._am_counts0 is not None:
            am_counts, am_n = self._am_counts0.clone(), self._am_n0.clone()
        else:
            am_counts, am_n = zeros(s, c, cfg.dim), zeros(s, c)
        return FleetState(counts=zeros(s, cfg.dim), filled=zeros(s),
                          frame_index=zeros(s),
                          class_rows=self._class_rows0.clone(),
                          am_counts=am_counts, am_n=am_n,
                          last_frame=zeros(s, cfg.words),
                          last_scores=zeros(s, c), has_frame=zeros(s))

    def reset(self) -> None:
        """Zero every accumulator, fill level and frame index, and restore
        every session's AM to its patient's trained state."""
        self._state = self._zero_state()
        self._filled_h[:] = 0
        self._fidx_h[:] = 0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_sessions(self) -> int:
        return self._n

    @property
    def state(self) -> FleetState:
        return self._state

    @property
    def fill_levels(self) -> np.ndarray:
        """(S,) cycles accumulated toward each next (incomplete) frame."""
        return self._filled_h.copy()

    @property
    def frame_indices(self) -> np.ndarray:
        """(S,) frames emitted so far per session."""
        return self._fidx_h.copy()

    # -- streaming ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise AssertionError("length exceeds max bucket")  # pragma: no cover

    def _stage_buf(self, slot: int, t_pad: int) -> torch.Tensor:
        """The (slot, bucket) staging buffer, safe to rewrite: waits for the
        last step that read it.  Pinned host memory on the card."""
        key = (slot, t_pad)
        done = self._stage_done.pop(key, None)
        if done is not None:
            done.synchronize()
        if key not in self._stage:
            self._stage[key] = torch.zeros(
                (self._n, t_pad, self._cfg.channels), dtype=torch.uint8,
                pin_memory=self._device.type == "cuda")
        return self._stage[key]

    def _validate(self, chunks: Sequence) -> tuple[list[np.ndarray], np.ndarray]:
        """Per-chunk dtype/shape validation; returns (arrays, lengths)."""
        ch = self._cfg.channels
        arrs = []
        for i, c in enumerate(chunks):
            a = np.asarray(c, dtype=np.uint8)
            if a.size == 0:
                a = a.reshape(0, ch)
            if a.ndim != 2 or a.shape[1] != ch:
                raise ValueError(
                    f"session {i}: chunk must be (t, {ch}), got {a.shape}")
            arrs.append(a)
        return arrs, np.asarray([a.shape[0] for a in arrs], np.int64)

    def _pack(self, arrs: list[np.ndarray], lengths: np.ndarray) -> np.ndarray:
        """Ragged chunk list -> one (S, T_max, ch) code batch.  Equal
        lengths are one concatenate + reshape; ragged pushes scatter into a
        reused buffer whose bytes past a session's length are dead cycles
        (masked by ``lengths``, clamped by the gather)."""
        ch = self._cfg.channels
        total = int(lengths.max(initial=0))
        flat = np.concatenate(arrs, axis=0)                # (sum(t_i), ch)
        if (lengths == total).all():
            return flat.reshape(self._n, total, ch)
        if self._ragged_buf is None or self._ragged_buf.shape[1] < total:
            cap = max(total, 2 * (0 if self._ragged_buf is None
                                  else self._ragged_buf.shape[1]))
            self._ragged_buf = np.zeros((self._n, cap, ch), np.uint8)
        big = self._ragged_buf
        rows = np.repeat(np.arange(self._n), lengths)
        starts = np.cumsum(lengths) - lengths
        cols = np.arange(int(lengths.sum())) - np.repeat(starts, lengths)
        big[rows, cols] = flat
        return big

    def _rounds(self, big: np.ndarray, lengths: np.ndarray) -> list[FleetRound]:
        """Advance the fleet over one packed (S, T, ch) code batch, one
        bucketed step per ``max_bucket`` cycles."""
        rounds: list[FleetRound] = []
        max_bucket = self._buckets[-1]
        cuda = self._device.type == "cuda"
        pos = 0
        total = int(lengths.max(initial=0))
        while pos < total:
            round_len = np.clip(lengths - pos, 0, max_bucket)
            t_pad = self._bucket_for(int(round_len.max()))
            width = min(t_pad, total - pos)
            n_emit = (self._filled_h + round_len) // self._cfg.window
            slot = self._stage_phase & 1
            self._stage_phase += 1
            stage = self._stage_buf(slot, t_pad)
            stage.numpy()[:, :width] = big[:, pos:pos + width]
            chunk = stage.to(self._device, non_blocking=True)
            lens = torch.as_tensor(round_len.astype(np.int32),
                                   device=self._device)
            self._state, fo = _fleet_step(
                self._state, self._tables, self._owner, self._thresholds,
                chunk, lens, cfg=self._cfg)
            if cuda:  # the staging slot is free once this step has run
                done = torch.cuda.Event()
                done.record()
                self._stage_done[(slot, t_pad)] = done
            rounds.append(FleetRound(out=fo, n_emit=n_emit,
                                     frame_base=self._fidx_h.copy()))
            self._filled_h += round_len - n_emit * self._cfg.window
            self._fidx_h += n_emit
            pos += max_bucket
        return rounds

    def push_raw(self, chunks: Sequence) -> list[FleetRound]:
        """Feed one (t_i, channels) uint8 chunk per session; returns one
        ``FleetRound`` per step without waiting for the device."""
        if len(chunks) != self._n:
            raise ValueError(
                f"push needs one chunk per session ({self._n}), got {len(chunks)}")
        arrs, lengths = self._validate(chunks)
        if int(lengths.max(initial=0)) == 0:
            return []
        return self._rounds(self._pack(arrs, lengths), lengths)

    def push_codes_raw(self, batch, lengths: Sequence[int] | None = None
                       ) -> list[FleetRound]:
        """Feed one pre-stacked (S, t, channels) uint8 code batch, with
        optional per-session valid lengths (default: all ``t``)."""
        batch = np.asarray(batch, np.uint8)
        ch = self._cfg.channels
        if batch.ndim != 3 or batch.shape[0] != self._n or batch.shape[2] != ch:
            raise ValueError(
                f"push_codes needs a ({self._n}, t, {ch}) batch, got "
                f"{batch.shape}")
        t = batch.shape[1]
        if lengths is None:
            lens = np.full((self._n,), t, np.int64)
        else:
            lens = np.asarray(lengths, np.int64)
            if lens.shape != (self._n,) or lens.min(initial=0) < 0 or \
                    lens.max(initial=0) > t:
                raise ValueError(
                    f"lengths must be ({self._n},) ints in [0, {t}]")
        if t == 0 or int(lens.max(initial=0)) == 0:
            return []
        return self._rounds(batch, lens)

    def push_codes(self, batch, lengths: Sequence[int] | None = None
                   ) -> list[list[FrameDecision]]:
        """``push`` for a pre-stacked (S, t, channels) code batch."""
        return self.collect_decisions(self.push_codes_raw(batch, lengths))

    def collect_decisions(self, rounds: Sequence[FleetRound]
                          ) -> list[list[FrameDecision]]:
        """Materialise per-session FrameDecision lists from raw rounds (the
        only place the fleet waits for the device)."""
        out: list[list[FrameDecision]] = [[] for _ in range(self._n)]
        for r in rounds:
            if not r.n_emit.any():
                continue
            frames = hv.to_u32(r.out.frames)
            scores = r.out.scores.cpu().numpy()
            preds = np.argmax(scores, axis=-1)
            for i in np.nonzero(r.n_emit)[0]:
                base = int(r.frame_base[i])
                out[i].extend(
                    FrameDecision(frame_index=base + k, scores=scores[i, k],
                                  prediction=int(preds[i, k]),
                                  frame_hv=frames[i, k])
                    for k in range(int(r.n_emit[i])))
        return out

    def push(self, chunks: Sequence) -> list[list[FrameDecision]]:
        """Feed one (t_i, channels) uint8 chunk per session (lengths may
        differ, 0 included); returns each session's completed decisions."""
        return self.collect_decisions(self.push_raw(chunks))

    # -- online adaptation ----------------------------------------------------

    @property
    def class_rows(self) -> np.ndarray:
        """(S, C, W) uint32 per-session (possibly adapted) class HV rows."""
        return hv.to_u32(self._state.class_rows)

    def adapt(self, labels: Sequence[int], *, margin: float = 0.0) -> np.ndarray:
        """Personalise all S sessions' AMs from one feedback label each:
        ``labels[i]`` is the true class of session ``i``'s last emitted
        frame, ``-1`` no feedback; sessions without a frame are skipped.
        Equal to ``SeizureSession.adapt`` per stream.  Returns the (S,) bool
        mask of sessions whose update fired."""
        if self._am_counts0 is None:
            raise ValueError(
                "fleet bank has pipelines without am_state counter files; "
                "train them with train_one_shot/fit_iterative to enable "
                "adapt()")
        lab = np.asarray(labels, np.int64)
        if lab.shape != (self._n,):
            raise ValueError(
                f"adapt needs one label per session ({self._n}), got shape "
                f"{lab.shape}")
        if lab.max(initial=-1) >= self._cfg.n_classes:
            raise ValueError(
                f"labels must be < n_classes={self._cfg.n_classes} "
                "(-1 = no feedback)")
        self._state, applied = _fleet_adapt(
            self._state, torch.as_tensor(lab, device=self._device), margin,
            self._density, cfg=self._cfg)
        return applied.cpu().numpy()

    # -- durability -----------------------------------------------------------

    def _meta(self) -> dict:
        return {
            "kind": "hdc_fleet",
            "n_sessions": self._n,
            "dim": self._cfg.dim,
            "window": self._cfg.window,
            "n_classes": self._cfg.n_classes,
            "variant": self._cfg.variant,
            "bank": self._bank_fingerprint(),
        }

    def _bank_fingerprint(self) -> str:
        """Digest of what a saved state is only valid against: the pre-bound
        tables, each session's table row, threshold and class density, and
        its initial class rows and counter file.  Packed words are hashed as
        uint32."""
        h = hashlib.sha256()
        operands = [hv.to_u32(self._tables), self._owner.cpu().numpy(),
                    self._thresholds.cpu().numpy(), self._density.cpu().numpy(),
                    hv.to_u32(self._class_rows0)]
        if self._am_counts0 is not None:
            operands += [self._am_counts0.cpu().numpy(), self._am_n0.cpu().numpy()]
        for arr in operands:
            arr = np.ascontiguousarray(arr)
            h.update(str((arr.dtype.str, arr.shape)).encode())
            h.update(arr.tobytes())
        return h.hexdigest()[:16]

    def save(self, root: str, step: int | None = None) -> str:
        """Checkpoint the whole fleet state (streaming accumulators and
        online AM banks) under ``root`` with the checkpoint module's atomic
        rename; ``step`` defaults to one past the latest.  Packed words are
        saved as uint32.  Returns the checkpoint directory."""
        if step is None:
            latest = ckpt.latest_step(root)
            step = 0 if latest is None else latest + 1
        host = FleetState(**{
            f.name: (hv.to_u32(getattr(self._state, f.name))
                     if f.name in _PACKED_LEAVES
                     else getattr(self._state, f.name).cpu().numpy())
            for f in fields(FleetState)})
        return ckpt.save(root, step, host, meta=self._meta())

    def restore(self, root: str, step: int | None = None) -> int:
        """Restore a ``save``d state into this fleet (the same bank and
        session count); pushes continue mid-stream from the restored fill
        levels.  Returns the step."""
        if step is None:
            step = ckpt.latest_step(root)
            if step is None:
                raise FileNotFoundError(f"no fleet checkpoint under {root!r}")
        with open(os.path.join(root, f"step_{step:08d}",
                               "manifest.json")) as f:
            meta = json.load(f).get("meta", {})
        want = self._meta()
        bad = {k: (meta.get(k), v) for k, v in want.items()
               if meta.get(k) != v}
        if bad:
            raise ValueError(
                f"checkpoint does not match this fleet: {bad} "
                "(saved, expected)")
        self._state = ckpt.restore(root, step, like=self._state)
        self._filled_h = self._state.filled.cpu().numpy().astype(np.int64)
        self._fidx_h = self._state.frame_index.cpu().numpy().astype(np.int64)
        return step
