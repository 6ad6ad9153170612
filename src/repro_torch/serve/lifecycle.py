"""Elastic session lifecycle on the fleet's capacity tiles (port of
``repro.serve.lifecycle``).

``ElasticFleet`` lets sessions come and go at runtime on top of the
fleet's capacity tiles:

Free-slot maps over capacity tiles
    Provisioned capacity stays whole tiles.  ``admit`` claims the lowest
    free slot and writes its row in place (``_slot_write``: indexed writes
    of one row of the tile's tensors, queued on the stream);  ``evict``
    returns the slot to the free map.  A free slot pushes zero-length
    chunks, and since ``filled < window`` always holds it never emits:
    stale state in a free slot is masked cycles.

Spill and compaction
    When every slot is taken the fleet spills one more tile, up to
    ``max_tiles``; ``compact()`` moves the trailing tile's sessions into
    earlier free slots (snapshot out, slot write in) and drops the tiles
    that empty out.

Reconnect with state
    ``evict(..., with_state=True)`` reads the slot's rows into a host
    ``SessionSnapshot`` (``_snapshot_slot``, the one place that reads the
    device back); readmitting it, here or in a ``SeizureSession``, resumes
    the stream bit-exactly, electrode mask included.

Overload backpressure
    ``offer`` admits, queues (up to ``queue_limit``) or sheds.  While
    arrivals are queued the fleet is overloaded and ``adapt`` does no work
    (counted in ``stats["adapt_shed"]``); evictions drain the queue oldest
    first.

Crash recovery
    ``save`` writes per-tile checkpoints (``tile_00/...``); tiles unchanged
    since the last save are hard-linked from its files.  Every mutating
    call is appended to a bounded replay ring, and ``restore`` +
    ``replay(events_since(cursor))`` reproduces the uninterrupted fleet's
    decisions bit-exactly.

Warm-up
    ``warmup`` captures the live tiles' steps and adapts as CUDA graphs
    (``StreamingFleet.warmup``); a tile that a spill adds to a warmed fleet
    is captured before its first step (``_warm_tile``), and a tile index
    that compaction dropped keeps its graphs for the next spill.
    ``from_checkpoint(..., aot_dir=, warm=)`` warms from the checkpoint's
    deploy artifact, then restores.  The reference also warms slot-write
    and slot-read executables; here those are indexed row writes and reads
    queued on the stream, with nothing to capture.

Tiles over the local devices
    As in ``StreamingFleet``, tiles round-robin over the local devices of
    the bank's type: a spilled tile lands on the next device and reuses
    that device's copy of the tables; slot writes and reads, spills,
    warm-ups, compaction and ``restore`` address the tile's device.  Mesh
    sharding stays on ``StreamingFleet``, as in the reference.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import json
import os
from dataclasses import fields
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import hv
from repro_torch.core.pipeline import HDCPipeline
from repro_torch.serve.engine import FrameDecision, SessionSnapshot
from repro_torch.serve.fleet import (_PACKED_LEAVES, DEFAULT_BUCKETS, FleetRound,
                                     FleetState, StreamingFleet, _artifact_for,
                                     _host_state, _mask_from_meta, _mask_meta, _on,
                                     derive_tile)


class CapacityError(RuntimeError):
    """The fleet is full and cannot spill another tile (``max_tiles``)."""


def _slot_write(state: FleetState, slot: int, rows: Sequence[torch.Tensor]
                ) -> None:
    """Overwrite row ``slot`` of every state leaf in place with ``rows``
    (one per leaf, in field order): indexed copies queued on the stream,
    with no read back to the host."""
    for f, row in zip(fields(FleetState), rows):
        getattr(state, f.name)[slot] = row


def _slot_read(state: FleetState, slot: int) -> tuple[torch.Tensor, ...]:
    """Row ``slot`` of every state leaf, in field order (views)."""
    return tuple(getattr(state, f.name)[slot] for f in fields(FleetState))


class ElasticFleet(StreamingFleet):
    """A ``StreamingFleet`` whose sessions come and go at runtime.

    ``pipelines`` is the patient -> trained-pipeline bank; capacity starts
    at one tile of ``tile`` slots and spills up to ``max_tiles`` tiles.
    Sessions are addressed by the integer session id ``admit``/``offer``
    return; ``push_sessions({sid: codes})`` advances whoever has traffic
    this round and returns ``{sid: [FrameDecision]}``.  See the module
    docstring for the lifecycle.
    """

    def __init__(self, pipelines: Mapping[Hashable, HDCPipeline], *,
                 tile: int | None = None, max_tiles: int = 4,
                 queue_limit: int = 32, log_rounds: int = 64,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 channel_masking: bool = False):
        if not pipelines:
            raise ValueError("ElasticFleet needs at least one pipeline")
        pids = list(pipelines)
        if tile is None:
            first = next(iter(pipelines.values()))
            tile = derive_tile(first.cfg, max_bucket=max(buckets),
                               device=first.device)
        if tile < len(pids):
            raise ValueError(
                f"tile={tile} < {len(pids)} patients: every patient needs "
                "at least one addressable slot in the owner cycle")
        if max_tiles < 1:
            raise ValueError(f"max_tiles={max_tiles} must be >= 1")
        # owners cycle the patient list so slot i < P starts as patient i:
        # the first P rows of the per-slot registers are the per-patient
        # registers admissions are written from
        owners = [pids[i % len(pids)] for i in range(tile)]
        super().__init__(pipelines, owners, buckets=buckets, tile=tile,
                         channel_masking=channel_masking)
        assert self._np == tile and len(self._tile_slices) == 1
        self._tile = int(tile)
        self._max_tiles = int(max_tiles)
        self._pid_of = {pid: i for i, pid in enumerate(pids)}
        p = len(pids)
        self._pat_thr = self._thr_h[:p].copy()
        self._pat_prow = self._prow_h[:p].copy()
        self._pat_dens = self._dens_h[:p].copy()
        self._pat_rows = self._class_rows0[:p].copy()
        if self._am_counts0 is not None:
            self._pat_am_counts = self._am_counts0[:p].copy()
            self._pat_am_n = self._am_n0[:p].copy()
        else:
            self._pat_am_counts = self._pat_am_n = None
        # lifecycle bookkeeping
        self._free: list[set[int]] = [set(range(tile))]
        self._sid_slot: dict[int, int] = {}
        self._slot_sid: dict[int, int] = {}
        self._sid_pid: dict[int, Hashable] = {}
        self._next_sid = 0
        self._queue: collections.deque = collections.deque()
        self._queue_limit = int(queue_limit)
        self._log: collections.deque = collections.deque(
            maxlen=int(log_rounds))
        self._op_id = 0
        self._stats = {"admitted": 0, "evicted": 0, "queued": 0, "shed": 0,
                       "adapt_shed": 0, "spills": 0, "compactions": 0}
        self._push_buf: np.ndarray | None = None

    # -- introspection ------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Provisioned slots (tiles x tile size); grows on spill, shrinks
        on compaction."""
        return self._np

    @property
    def sessions(self) -> dict[int, Hashable]:
        """``{session id: patient id}`` of every live session."""
        return dict(sorted(self._sid_pid.items()))

    @property
    def free_slots(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def overloaded(self) -> bool:
        """True while admissions are queued: ``adapt`` does no work until
        the queue drains."""
        return bool(self._queue)

    @property
    def stats(self) -> dict[str, int]:
        return dict(self._stats)

    @property
    def op_id(self) -> int:
        """Monotonic cursor of mutating operations; checkpoints record it
        and ``events_since``/``replay`` are keyed by it."""
        return self._op_id

    def slot_of(self, sid: int) -> int:
        return self._sid_slot[sid]

    # -- slot surgery ---------------------------------------------------------

    def _fresh_rows(self, p: int) -> tuple:
        """A patient's pristine state row (fresh connection)."""
        cfg = self._cfg
        c = cfg.n_classes
        if self._pat_am_counts is not None:
            am_c, am_n = self._pat_am_counts[p], self._pat_am_n[p]
        else:
            am_c = np.zeros((c, cfg.dim), np.int32)
            am_n = np.zeros((c,), np.int32)
        return (np.zeros((cfg.dim,), np.int32), np.int32(0), np.int32(0),
                self._pat_rows[p], am_c, am_n,
                np.zeros((cfg.words,), np.uint32),
                np.zeros((c,), np.int32), np.int32(0))

    def _snap_rows(self, snap: SessionSnapshot) -> tuple:
        """A reconnecting session's state row, checked against this fleet's
        geometry."""
        cfg = self._cfg
        c = cfg.n_classes
        counts = np.asarray(snap.counts, np.int32)
        rows = np.asarray(snap.class_rows, np.uint32)
        lastf = np.asarray(snap.last_frame, np.uint32)
        lasts = np.asarray(snap.last_scores, np.int32)
        if (counts.shape != (cfg.dim,) or rows.shape != (c, cfg.words)
                or lastf.shape != (cfg.words,) or lasts.shape != (c,)):
            raise ValueError(
                f"snapshot geometry {counts.shape}/{rows.shape} does not "
                f"match this fleet (dim={cfg.dim}, classes={c}, "
                f"words={cfg.words})")
        if not 0 <= int(snap.filled) < cfg.window:
            raise ValueError(
                f"snapshot filled={snap.filled} outside [0, {cfg.window})")
        if snap.am_counts is not None:
            am_c = np.asarray(snap.am_counts, np.int32)
            am_n = np.asarray(snap.am_n, np.int32)
            if am_c.shape != (c, cfg.dim) or am_n.shape != (c,):
                raise ValueError(
                    f"snapshot AM geometry {am_c.shape} does not match "
                    f"this fleet ({c}, {cfg.dim})")
        else:
            am_c = np.zeros((c, cfg.dim), np.int32)
            am_n = np.zeros((c,), np.int32)
        return (counts, np.int32(snap.filled), np.int32(snap.frame_index),
                rows, am_c, am_n, lastf, lasts, np.int32(snap.has_frame))

    def _reput_registers(self, k: int) -> None:
        sl, dev = self._tile_slices[k], self._tile_devs[k]
        self._thresholds_t[k] = self._put(self._thr_h[sl], device=dev)
        self._param_owner_t[k] = self._put(self._prow_h[sl], device=dev)
        self._density_t[k] = self._put(self._dens_h[sl], device=dev)
        if self._masked:
            self._cmask_t[k] = self._put(self._cmask_h[sl], torch.int32, dev)

    def _write_slot(self, slot: int, pid: Hashable,
                    snapshot: SessionSnapshot | None) -> None:
        """Re-initialise one slot's device row (fresh or from a snapshot)
        and its host mirrors and operand registers."""
        k = slot // self._tile
        sl = self._tile_slices[k]
        p = self._pid_of[pid]
        rows = (self._fresh_rows(p) if snapshot is None
                else self._snap_rows(snapshot))
        # packed words travel as their int32 carrier
        dev_rows = [self._put(hv.to_i32(r) if r.dtype == np.uint32 else r,
                              device=self._tile_devs[k])
                    for r in map(np.asarray, rows)]
        _slot_write(self._state_t[k], slot - sl.start, dev_rows)
        self._dirty_t[k] = True
        self._filled_h[slot] = int(rows[1])
        self._fidx_h[slot] = int(rows[2])
        self._thr_h[slot] = self._pat_thr[p]
        self._prow_h[slot] = self._pat_prow[p]
        self._dens_h[slot] = self._pat_dens[p]
        if self._masked:
            # the electrode quarantine follows the session: a snapshot
            # brings its mask back, a fresh admission starts all-live
            ch = self._cfg.channels
            if snapshot is not None and snapshot.channel_mask is not None:
                cm = np.asarray(snapshot.channel_mask, np.uint8)
                if cm.shape != (ch,):
                    raise ValueError(
                        f"snapshot channel_mask must be ({ch},), got "
                        f"{cm.shape}")
                self._cmask_h[slot] = cm
            else:
                self._cmask_h[slot] = 1
        self._reput_registers(k)

    def _snapshot_slot(self, slot: int) -> SessionSnapshot:
        """Read one slot's state row into a host ``SessionSnapshot``: the
        one place the lifecycle waits for the device."""
        k = slot // self._tile
        sl = self._tile_slices[k]
        # copies: a CPU tensor's numpy view would follow later slot writes
        counts, _, _, rows, am_c, am_n, lastf, lasts, hasf = (
            np.array(hv.to_u32(r) if f.name in _PACKED_LEAVES else r.cpu().numpy())
            for f, r in zip(fields(FleetState),
                            _slot_read(self._state_t[k], slot - sl.start)))
        has_am = self._am_counts0 is not None
        return SessionSnapshot(
            patient_id=self._sid_pid[self._slot_sid[slot]],
            counts=counts,
            filled=int(self._filled_h[slot]),
            frame_index=int(self._fidx_h[slot]),
            class_rows=rows,
            am_counts=am_c if has_am else None,
            am_n=am_n if has_am else None,
            last_frame=lastf, last_scores=lasts, has_frame=int(hasf),
            channel_mask=(self._cmask_h[slot].copy()
                          if self._masked else None))

    # -- tile growth / shrink -----------------------------------------------

    def _spill_tile(self) -> int:
        """Append one more capacity tile; raises ``CapacityError`` at
        ``max_tiles``."""
        if len(self._tile_slices) >= self._max_tiles:
            raise CapacityError(
                f"fleet at max_tiles={self._max_tiles} "
                f"({self.capacity} slots)")
        k = len(self._tile_slices)
        t = self._tile
        start = self._np
        sl = slice(start, start + t)
        self._tile_slices.append(sl)
        self._rows_t.append(sl)
        dev = self._devs[k % len(self._devs)]
        self._tile_devs.append(dev)
        if dev not in self._tables_dev:
            self._tables_dev[dev] = self._tables.to(dev)
        # grow the host per-slot arrays by one tile of placeholder rows
        # (the first tile's pattern; admissions overwrite per slot)
        self._class_rows0 = np.concatenate(
            [self._class_rows0, self._class_rows0[:t]])
        if self._am_counts0 is not None:
            self._am_counts0 = np.concatenate(
                [self._am_counts0, self._am_counts0[:t]])
            self._am_n0 = np.concatenate([self._am_n0, self._am_n0[:t]])
        for name in ("_thr_h", "_prow_h", "_dens_h"):
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, arr[:t]]))
        self._filled_h = np.concatenate(
            [self._filled_h, np.zeros((t,), np.int64)])
        self._fidx_h = np.concatenate(
            [self._fidx_h, np.zeros((t,), np.int64)])
        if self._masked:
            self._cmask_h = np.concatenate(
                [self._cmask_h,
                 np.ones((t, self._cfg.channels), np.uint8)])
            self._cmask_t.append(None)  # filled by _reput_registers below
        self._np += t
        self._n = self._np
        for lst in (self._thresholds_t, self._param_owner_t,
                    self._density_t):
            lst.append(None)            # likewise
        self._reput_registers(k)
        self._state_t.append(self._zero_state(k))
        self._stage_t.append({})
        self._stage_done_t.append({})
        self._dirty_t.append(True)
        self._free.append(set(range(start, start + t)))
        self._ragged_buf = None  # the scatter buffers are capacity-shaped
        self._push_buf = None
        self._stats["spills"] += 1
        if self._graphs:
            self._warm_tile(k)
        return k

    def _warm_tile(self, k: int) -> None:
        """Capture tile ``k``'s step at every bucket, and its adapt, unless
        captured already (a tile index compaction dropped keeps its
        graphs): a warmed fleet's spilled tile is captured before its first
        step, on its device."""
        with _on(self._tile_devs[k]):
            for b in self._buckets:
                if (k, b) not in self._graphs:
                    self._capture_step(k, b)
            if self._am_counts0 is not None and k not in self._adapt_graphs:
                self._capture_adapt(k)

    def _drop_last_tile(self) -> None:
        """Drop the trailing tile (it must hold no live session), with its
        state, registers, staging buffers and their pending events."""
        k = len(self._tile_slices) - 1
        sl = self._tile_slices[k]
        if any(slot in self._slot_sid for slot in range(sl.start, sl.stop)):
            raise RuntimeError("dropping a tile with live sessions")
        for lst in (self._tile_slices, self._rows_t, self._tile_devs, self._state_t,
                    self._thresholds_t, self._param_owner_t, self._density_t,
                    self._stage_t, self._stage_done_t, self._dirty_t, self._free):
            lst.pop()
        if self._masked:
            self._cmask_t.pop()
        self._np -= self._tile
        self._n = self._np
        for name in ("_filled_h", "_fidx_h", "_thr_h", "_prow_h",
                     "_dens_h"):
            setattr(self, name, getattr(self, name)[:self._np].copy())
        if self._masked:
            self._cmask_h = self._cmask_h[:self._np].copy()
        self._class_rows0 = self._class_rows0[:self._np].copy()
        if self._am_counts0 is not None:
            self._am_counts0 = self._am_counts0[:self._np].copy()
            self._am_n0 = self._am_n0[:self._np].copy()
        self._ragged_buf = None
        self._push_buf = None

    # -- admission / eviction -----------------------------------------------

    def _logged(self, kind: str, payload) -> None:
        self._log.append((self._op_id, kind, payload))
        self._op_id += 1

    def _take_slot(self) -> int:
        """Claim the lowest free slot, spilling a tile when none is free;
        raises CapacityError at max_tiles."""
        for free in self._free:
            if free:
                slot = min(free)
                free.discard(slot)
                return slot
        k = self._spill_tile()
        slot = min(self._free[k])
        self._free[k].discard(slot)
        return slot

    def _place(self, pid: Hashable,
               snapshot: SessionSnapshot | None) -> int:
        slot = self._take_slot()
        sid = self._next_sid
        self._next_sid += 1
        self._write_slot(slot, pid, snapshot)
        self._sid_slot[sid] = slot
        self._slot_sid[slot] = sid
        self._sid_pid[sid] = pid
        self._stats["admitted"] += 1
        return sid

    def _check_admission(self, pid: Hashable,
                         snapshot: SessionSnapshot | None) -> None:
        if pid not in self._pid_of:
            raise KeyError(f"unknown patient id {pid!r}")
        if snapshot is not None and snapshot.patient_id is not None \
                and snapshot.patient_id != pid:
            raise ValueError(
                f"snapshot belongs to patient {snapshot.patient_id!r}, "
                f"admission names {pid!r}")

    def admit(self, patient_id: Hashable, *,
              snapshot: SessionSnapshot | None = None) -> int:
        """Admit one session (fresh, or resuming from an eviction
        ``SessionSnapshot``) into the lowest free slot; returns its session
        id.  Spills a new tile when full; raises :class:`CapacityError` at
        ``max_tiles`` (``offer`` queues or sheds instead)."""
        self._check_admission(patient_id, snapshot)
        self._logged("admit", (patient_id, snapshot))
        return self._place(patient_id, snapshot)

    def offer(self, patient_id: Hashable, *,
              snapshot: SessionSnapshot | None = None
              ) -> tuple[str, int | None]:
        """Backpressured admission: ``("admitted", sid)`` when a slot (or a
        spill) is available, ``("queued", None)`` when full but the bounded
        queue has room (drained oldest first by evictions), and ``("shed",
        None)`` beyond that."""
        self._check_admission(patient_id, snapshot)
        if snapshot is not None and snapshot.patient_id is None:
            # a queued snapshot carries its patient through checkpoints
            snapshot = dataclasses.replace(snapshot, patient_id=patient_id)
        self._logged("offer", (patient_id, snapshot))
        if self._queue or self.free_slots == 0 and \
                len(self._tile_slices) >= self._max_tiles:
            if len(self._queue) >= self._queue_limit:
                self._stats["shed"] += 1
                return ("shed", None)
            self._queue.append((patient_id, snapshot))
            self._stats["queued"] += 1
            return ("queued", None)
        return ("admitted", self._place(patient_id, snapshot))

    def evict(self, session_ids: Sequence[int], *,
              with_state: bool = True
              ) -> dict[int, SessionSnapshot | None]:
        """Evict sessions, returning ``{sid: SessionSnapshot}`` (``None``
        values under ``with_state=False``).  Slots return to the free map
        without touching device state, and queued admissions drain into
        them oldest first."""
        sids = [int(s) for s in session_ids]
        for sid in sids:
            if sid not in self._sid_slot:
                raise KeyError(f"unknown session id {sid}")
        self._logged("evict", (tuple(sids), with_state))
        out: dict[int, SessionSnapshot | None] = {}
        for sid in sids:
            slot = self._sid_slot[sid]
            out[sid] = self._snapshot_slot(slot) if with_state else None
            self._free[slot // self._tile].add(slot)
            del self._sid_slot[sid]
            del self._slot_sid[slot]
            del self._sid_pid[sid]
            self._stats["evicted"] += 1
        self._drain_queue()
        return out

    def _drain_queue(self) -> None:
        while self._queue and not (self.free_slots == 0 and
                                   len(self._tile_slices) >= self._max_tiles):
            self._place(*self._queue.popleft())

    def compact(self) -> int:
        """Move the trailing tile's sessions into earlier free slots
        (snapshot out, slot write in) and drop trailing tiles that empty
        out; a tile is drained only when the earlier tiles can take all its
        sessions.  Returns the number of tiles dropped."""
        self._logged("compact", ())
        dropped = 0
        while len(self._tile_slices) > 1:
            k = len(self._tile_slices) - 1
            sl = self._tile_slices[k]
            live = sorted(s for s in range(sl.start, sl.stop)
                          if s in self._slot_sid)
            if len(live) > sum(len(self._free[j]) for j in range(k)):
                break
            for slot in live:
                sid = self._slot_sid[slot]
                snap = self._snapshot_slot(slot)
                del self._slot_sid[slot]
                new_slot = self._take_slot()  # earlier tiles have room
                self._write_slot(new_slot, self._sid_pid[sid], snap)
                self._sid_slot[sid] = new_slot
                self._slot_sid[new_slot] = sid
            self._drop_last_tile()
            dropped += 1
            self._stats["compactions"] += 1
        return dropped

    # -- traffic ------------------------------------------------------------

    def push_sessions_raw(self, chunks: Mapping[int, np.ndarray]
                          ) -> tuple[list[FleetRound], dict[int, int]]:
        """Advance the sessions named in ``chunks`` (``{sid: (t, channels)
        uint8 codes}``, lengths may differ; everyone else idles this
        round).  Returns the raw rounds and the ``{sid: slot}`` routing of
        this push; ``push_sessions`` collects the decisions."""
        ch = self._cfg.channels
        lengths = np.zeros((self._np,), np.int64)
        arrs: dict[int, np.ndarray] = {}
        t_max = 0
        for sid, codes in chunks.items():
            slot = self._sid_slot.get(int(sid))
            if slot is None:
                raise KeyError(f"unknown session id {sid}")
            a = np.asarray(codes, np.uint8)
            if a.size == 0:
                a = a.reshape(0, ch)
            if a.ndim != 2 or a.shape[1] != ch:
                raise ValueError(
                    f"session {sid}: chunk must be (t, {ch}), "
                    f"got {a.shape}")
            arrs[slot] = a
            lengths[slot] = a.shape[0]
            t_max = max(t_max, a.shape[0])
        self._logged("push", {int(s): arrs[self._sid_slot[int(s)]].copy()
                              for s in chunks})
        mapping = {int(sid): self._sid_slot[int(sid)] for sid in chunks}
        if t_max == 0:
            return [], mapping
        if self._push_buf is None or self._push_buf.shape[0] < self._np \
                or self._push_buf.shape[1] < t_max:
            cap = max(t_max, self._buckets[-1],
                      0 if self._push_buf is None
                      else 2 * self._push_buf.shape[1])
            self._push_buf = np.zeros((self._np, cap, ch), np.uint8)
        big = self._push_buf
        for slot, a in arrs.items():
            big[slot, :a.shape[0]] = a  # stale bytes past t are masked
        return self._rounds(big, lengths), mapping

    def push_sessions(self, chunks: Mapping[int, np.ndarray]
                      ) -> dict[int, list[FrameDecision]]:
        """``push_sessions_raw`` and the decisions: ``{sid:
        [FrameDecision]}`` for every pushed session (empty when its chunk
        completed no frame)."""
        rounds, mapping = self.push_sessions_raw(chunks)
        decs = self.collect_decisions(rounds)
        return {sid: decs[slot] for sid, slot in mapping.items()}

    def adapt(self, labels: Mapping[int, int], *,  # type: ignore[override]
              margin: float = 0.0) -> dict[int, bool]:
        """Feedback for live sessions: ``{sid: true label of its last
        emitted frame}``.  While overloaded (queued admissions) the call is
        shed: every verdict False, counted in ``stats["adapt_shed"]``."""
        labels = {int(s): int(v) for s, v in labels.items()}
        for sid in labels:
            if sid not in self._sid_slot:
                raise KeyError(f"unknown session id {sid}")
        self._logged("adapt", (dict(labels), float(margin)))
        if self._queue:
            self._stats["adapt_shed"] += 1
            return {sid: False for sid in labels}
        full = np.full((self._n,), -1, np.int64)
        for sid, lab in labels.items():
            full[self._sid_slot[sid]] = lab
        applied = super().adapt(full, margin=margin)
        return {sid: bool(applied[self._sid_slot[sid]]) for sid in labels}

    # -- replay recovery ----------------------------------------------------

    def events_since(self, op_id: int) -> list[tuple]:
        """The replay-ring suffix at or after ``op_id`` (a checkpoint's
        recorded cursor).  Raises when the bounded ring has already dropped
        events from that window."""
        events = [e for e in self._log if e[0] >= op_id]
        if events and events[0][0] != op_id and \
                (not self._log or self._log[0][0] > op_id):
            raise ValueError(
                f"replay ring starts at op {self._log[0][0]}, checkpoint "
                f"cursor is {op_id}: events were dropped (log_rounds="
                f"{self._log.maxlen})")
        return events

    def replay(self, events: Sequence[tuple]) -> dict[int, object]:
        """Re-apply a contiguous event suffix onto a just-restored fleet
        through the public API (which logs them again).  Returns ``{op_id:
        result}`` (push decisions, admitted sids, offer verdicts, evictions,
        adapt verdicts, tiles dropped)."""
        results: dict[int, object] = {}
        for op, kind, payload in events:
            if op != self._op_id:
                raise ValueError(
                    f"replay gap: event {op} arrived while the fleet "
                    f"expects {self._op_id} (non-contiguous suffix)")
            if kind == "push":
                results[op] = self.push_sessions(payload)
            elif kind == "admit":
                pid, snap = payload
                results[op] = self.admit(pid, snapshot=snap)
            elif kind == "offer":
                pid, snap = payload
                results[op] = self.offer(pid, snapshot=snap)
            elif kind == "evict":
                sids, with_state = payload
                results[op] = self.evict(sids, with_state=with_state)
            elif kind == "adapt":
                labels, margin = payload
                results[op] = self.adapt(labels, margin=margin)
            elif kind == "compact":
                results[op] = self.compact()
            else:  # pragma: no cover - the ring holds only the kinds above
                raise ValueError(f"unknown replay event kind {kind!r}")
        return results

    # -- durability ---------------------------------------------------------

    @staticmethod
    def _tile_key(k: int) -> str:
        return f"tile_{k:02d}"

    def _meta(self) -> dict:
        return {
            "kind": "elastic_fleet",
            "tile": self._tile,
            "dim": self._cfg.dim,
            "window": self._cfg.window,
            "n_classes": self._cfg.n_classes,
            "variant": self._cfg.variant,
            "bank": self._bank_fingerprint(),
        }

    def _bank_fingerprint(self) -> str:
        """Patient-level digest, invariant to which sessions occupy which
        slots: the tables, then each patient's table row, threshold, class
        density, class rows and counter file."""
        operands = [hv.to_u32(self._tables), self._pat_prow, self._pat_thr,
                    self._pat_dens, self._pat_rows]
        if self._pat_am_counts is not None:
            operands += [self._pat_am_counts, self._pat_am_n]
        return self._digest(operands)

    def _lifecycle_meta(self) -> dict:
        out = {
            "n_tiles": len(self._tile_slices),
            "sessions": [[sid, slot, json.dumps(self._sid_pid[sid])]
                         for sid, slot in sorted(self._sid_slot.items())],
            "next_sid": self._next_sid,
            "op_id": self._op_id,
            "queue": [[json.dumps(pid),
                       None if snap is None
                       else base64.b64encode(snap.to_bytes()).decode()]
                      for pid, snap in self._queue],
            "stats": dict(self._stats),
        }
        if self._masked:
            out["channel_mask"] = _mask_meta(self._cmask_h[:self._np])
        return out

    def save(self, root: str, step: int | None = None,
             aot_dir: str | None = None) -> str:
        """Incremental per-tile checkpoint: tiles unchanged since the last
        ``save`` are hard-linked from the previous step's files, never read
        back; the session table, the queue (snapshots and all) and the
        replay cursor ride the manifest meta.  ``restore`` + ``replay`` of
        the events after the cursor is the crash-recovery contract.
        ``aot_dir`` writes the deploy artifact and records it, as
        ``StreamingFleet.save`` does."""
        if step is None:
            latest = ckpt.latest_step(root)
            step = 0 if latest is None else latest + 1
        link_from: dict[str, str] = {}
        prev = ckpt.latest_step(root)
        if prev is not None and prev < step:
            try:
                prev_files = ckpt.leaf_files(root, prev)
            except (OSError, json.JSONDecodeError):
                prev_files = {}
            for k in range(len(self._state_t)):
                if self._dirty_t[k]:
                    continue
                prefix = self._tile_key(k) + "/"
                link_from.update({key: path
                                  for key, path in prev_files.items()
                                  if key.startswith(prefix)})
        tree = {}
        for k, st in enumerate(self._state_t):
            key = self._tile_key(k)
            if all(f"{key}/{f.name}" in link_from for f in fields(FleetState)):
                # linked leaves: only their shape and dtype are read
                tree[key] = FleetState(**{
                    f.name: np.broadcast_to(
                        np.zeros((), np.uint32 if f.name in _PACKED_LEAVES else np.int32),
                        getattr(st, f.name).shape)
                    for f in fields(FleetState)})
            else:
                tree[key] = _host_state(st)
        meta = dict(self._meta())
        meta["lifecycle"] = self._lifecycle_meta()
        path = ckpt.save(root, step, tree, meta=meta, link_from=link_from,
                         aot=self._save_aot_entry(aot_dir))
        self._dirty_t = [False] * len(self._state_t)
        return path

    def restore(self, root: str, step: int | None = None) -> int:
        """Restore a ``save``d elastic fleet into this fleet (same patient
        bank and tile size; the tile count follows the checkpoint: this
        fleet spills or drops tiles to match).  Live sessions, the queue
        and the replay cursor come back exactly; follow with
        ``replay(events)`` to reproduce the traffic after it."""
        if step is None:
            step = ckpt.latest_step(root)
            if step is None:
                raise FileNotFoundError(
                    f"no fleet checkpoint under {root!r}")
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
        life = meta.get("lifecycle")
        if life is None:
            raise ValueError(
                "checkpoint lacks lifecycle meta (saved by a non-elastic "
                "fleet?)")
        self._sid_slot.clear()
        self._slot_sid.clear()
        self._sid_pid.clear()
        self._queue.clear()
        self._log.clear()
        n_tiles = int(life["n_tiles"])
        while len(self._tile_slices) < n_tiles:
            self._spill_tile()
        while len(self._tile_slices) > n_tiles:
            self._drop_last_tile()
        like = {self._tile_key(k): self._state_t[k] for k in range(n_tiles)}
        restored = ckpt.restore(root, step, like=like)
        self._state_t = [restored[self._tile_key(k)] for k in range(n_tiles)]
        self._filled_h = np.concatenate(
            [st.filled.cpu().numpy() for st in self._state_t]).astype(np.int64)
        self._fidx_h = np.concatenate(
            [st.frame_index.cpu().numpy() for st in self._state_t]
        ).astype(np.int64)
        # the session table and the per-slot operand registers
        self._free = [set(range(sl.start, sl.stop))
                      for sl in self._tile_slices]
        self._thr_h[:] = self._pat_thr[0]
        self._prow_h[:] = self._pat_prow[0]
        self._dens_h[:] = self._pat_dens[0]
        for sid, slot, pid_json in life["sessions"]:
            pid = json.loads(pid_json)
            if pid not in self._pid_of:
                raise ValueError(
                    f"checkpointed session {sid} belongs to unknown "
                    f"patient {pid!r}")
            sid, slot = int(sid), int(slot)
            self._free[slot // self._tile].discard(slot)
            self._sid_slot[sid] = slot
            self._slot_sid[slot] = sid
            self._sid_pid[sid] = pid
            p = self._pid_of[pid]
            self._thr_h[slot] = self._pat_thr[p]
            self._prow_h[slot] = self._pat_prow[p]
            self._dens_h[slot] = self._pat_dens[p]
        if self._masked:
            self._cmask_h = _mask_from_meta(life.get("channel_mask"),
                                            (self._np, self._cfg.channels))
        for k in range(n_tiles):
            self._reput_registers(k)
        for pid_json, b64snap in life["queue"]:
            snap = (None if b64snap is None
                    else SessionSnapshot.from_bytes(
                        base64.b64decode(b64snap)))
            self._queue.append((json.loads(pid_json), snap))
        self._next_sid = int(life["next_sid"])
        self._op_id = int(life["op_id"])
        self._stats.update({k: int(v)
                            for k, v in life.get("stats", {}).items()})
        self._dirty_t = [True] * n_tiles
        return step

    @classmethod
    def from_checkpoint(cls, pipelines: Mapping[Hashable, HDCPipeline],
                        root: str, *, step: int | None = None,
                        aot_dir: str | None = None, warm: bool = True,
                        **fleet_kwargs) -> "ElasticFleet":
        """Worker restart: build an elastic fleet, warm it (from the deploy
        artifact the checkpoint records, or ``aot_dir``; a stale one warns
        and warms from the usual build) and restore the checkpointed
        lifecycle state, capturing each tile the restore spills; the caller
        then ``replay``s the surviving event suffix to catch up to the
        crash point."""
        fleet = cls(pipelines, **fleet_kwargs)
        if step is None:
            step = ckpt.latest_step(root)
            if step is None:
                raise FileNotFoundError(
                    f"no fleet checkpoint under {root!r}")
        art = _artifact_for(root, step, aot_dir, fleet.device)
        if warm:
            fleet.warmup(aot=art)
        fleet.restore(root, step)
        return fleet

    @classmethod
    def from_artifact(cls, *args, **kwargs):
        raise NotImplementedError(
            "ElasticFleet restores via from_checkpoint(pipelines, root) — "
            "its session set lives in the checkpoint, not a constructor "
            "owners list")
