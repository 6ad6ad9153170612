"""Streaming fleet: S concurrent sessions advanced by one device step a
capacity tile (port of the core of ``repro.serve.fleet.StreamingFleet``).

The fleet keeps its sessions in device-resident ``FleetState``s, one per
capacity tile:

* ``counts``      (S, D) int32 — the stacked temporal accumulators,
* ``filled``      (S,)   int32 — cycles accumulated toward each next frame,
* ``frame_index`` (S,)   int32 — frames emitted so far,

plus each session's class rows, its online counter file (``am_counts``,
``am_n``) and its last emitted frame and scores.  One step advances one
tile over a padded (tile_s, t_pad, channels) uint8 code batch: the fused
fleet kernel gathers the pre-bound rows, bundles them (OR tree for
``sparse_compim``; adder tree with thinning for ``spatial_thinning`` and
``sparse_naive``; channel majority for dense) and counts every frame slot
of the step (``kernels/hdc_fleet``); the carried counts are added, frames
are threshold-packed (dense: majority over the window) and scored against
the session's class rows (plain tensor code, as in the reference).

Capacity tiles: sessions are provisioned in whole tiles of ``tile`` slots
(``derive_tile``: the ``REPRO_FLEET_TILE`` override, else sized from the
card's memory, else ``DEFAULT_TILE`` on the CPU), so ``state`` and the
checkpoints carry the padded capacity; rows past ``n_sessions`` are phantom
slots that push zero-length chunks and never emit or adapt.  A fleet
smaller than a quarter tile keeps its exact size.  Every tile steps every
round (one kernel launch a tile).  Tiles round-robin over the local devices
of the bank's type (``device.local_devices``: every card of the host,
starting at the bank's; the CPU is one device): the bank's tables are
copied once a device, and each tile's operands, state, staging buffers,
ECC counters, fault draws and captured graphs live on its own device, so
steps on different cards run concurrently.  ``state``, ``save`` and
``collect_decisions`` bring the tiles' rows together on the host or the
bank's device.

Chunks may have any length per session (0 included).  Lengths are padded
to the smallest bucket that fits, and a chunk longer than the largest
bucket splits over several steps.  Ingest goes through pinned host staging
buffers per (tile, slot, bucket), the codes and the lengths, copied with
``non_blocking=True`` and double-buffered: a buffer is rewritten only after
the step that read it has finished (a CUDA event recorded after that step).
Other host-to-device writes (registers, slot rows, masks) go through
pinned copies too.  The host keeps O(S) mirrors of ``filled``/
``frame_index`` to route results without a sync; pushes never wait for the
device, ``collect_decisions`` does (and so do ``adapt``, ``save`` and
``restore``, which return host values).

``channel_masking=True`` carries a per-session (S, channels) electrode
mask (1 = live) into the fleet kernel's mask operand: masked channels
drop out of the spatial bundle with renormalised denominators.  The mask
survives ``reset`` and rides ``save``'s manifest meta.  Without masking
the step makes the kernel call it always made.

``faults=FaultConfig(...)`` (``reliability/faults.py``) makes the fleet a
degradation testbench: every step corrupts the reads of the enabled
memories (the codebook bank, XORed next to the fleet-kernel launch; the
AM class rows, read through the ECC word codec when a scheme is set; the
carried counters' low bits) at the configured bit-error rates, and
``ecc_stats`` accumulates each session's [corrected, detected,
uncorrectable] word counts on the device.  Each (tile, round) draws its
masks on the fleet's device from ``faults.step_seed``; stuck-mode draws are
kept per tile until ``set_ber`` moves the BERs.  ``faults=None`` makes the
step's fault-free call; BER 0 is bit-exact with it.

``adapt`` applies one gated online update to every session at once (plain
torch, ``core/online.py``), and ``save``/``restore`` checkpoint the whole
state mid-stream (``ckpt/checkpoint.py``).

Warm-up (``warmup``; the reference's AOT executables) captures each tile's
step at each bucket, and its adapt, as a CUDA graph (``runtime/graphs.py``)
over static tensors: the staged codes and lengths a (tile, bucket), the
tile's state leaves and operand registers, for a faulted fleet its draw.
A tile's state then lives in those static tensors and replays update it in
place; whatever replaces a tile's state or registers (``adapt`` run
eagerly, ``restore``, ``reset``, slot writes) is copied in before the next
replay.  Each round's frames and scores are copied out of the graph's
outputs into tensors of their own, so rounds not yet collected survive
later replays (a fixed ring of output buffers would be overwritten by a
push of more rounds than it holds).  The pinned
copy of the staged inputs stays outside the graph, ordered before the
replay on the stream; a faulted round's draw is made eagerly and copied
into the static draw.  A replay that fails raises: a warmed fleet never
falls back to eager steps behind the caller's back.  On the CPU warm-up
captures nothing.  ``save_aot``/``from_artifact`` ship and load the kernel
library (``runtime/aot.py``); graphs are captured by each worker.

Mesh placement (``mesh=``, a ``launch/mesh.py`` mesh): an SPMD fleet.
Every rank builds it from the same bank and owners and calls ``push``,
``adapt``, ``set_channel_mask``, ``set_ber``, ``save`` and ``restore``
with the same arguments.  Capacity is one tile spanning the mesh; its
session axis follows the ``batch`` rule (``runtime/sharding.py``: ``data``,
or ``pod`` and ``data``), so each rank keeps its contiguous block of every
state leaf (the reference's ``_STATE_AXES`` shard each leaf's leading
session axis alone, so one session sharding, ``_session_sh``, places them
all) and stages, steps (one fleet-kernel launch on plain local tensors)
and adapts only that block; a ``model`` axis holds copies,
and an axis product that does not divide the capacity replicates the
sessions on every rank, as the reference's ``_sanitize`` does.  The bank is
replicated.  Sessions are independent, so a step needs no collective; the
only cross-rank traffic is a host-side gather (CPU tensors over the group's
``gloo`` backend) of the rounds' frames and scores in
``collect_decisions``, and of the state in ``state``, ``class_rows``,
``adapt``'s verdicts, ``ecc_stats`` and ``save`` (rank 0 writes).
Arguments are validated before any collective, so a bad call raises on
every rank.  Fault draws are made for the whole tile on every rank from
the same seed and sliced to the block, so a faulted mesh fleet decides as
the unsharded one.  ``restore`` re-shards: a checkpoint holds full arrays,
so a state saved by any mesh, by an unsharded fleet or by the reference
restores onto any mesh.  ``warmup`` warns and captures nothing under a mesh
(the reference's mesh fleets skip their AOT path), and ``save_aot`` raises.

Decisions are bit-exact with the reference fleet, warmed, tiled over
several devices or on a mesh.  ``stage_probes`` breaks a CPU fleet's round
into the reference's four plain stages; a fleet on the card refuses.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Hashable, Mapping, Sequence

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import hv, online
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.reliability import ecc as rel_ecc
from repro_torch.reliability import faults as rel_faults
from repro_torch.reliability.faults import FaultConfig, FaultPlan, StepDraw
from repro_torch.runtime import aot as aot_mod
from repro_torch.runtime import graphs
from repro_torch.runtime import sharding as shd
from repro_torch.serve import dispatch
from repro_torch.serve.engine import FrameDecision, _pack_frames

DEFAULT_BUCKETS = (32, 64, 128, 256)
# sessions a device step on the CPU, where the device reports no memory
DEFAULT_TILE = 256


def derive_tile(cfg: HDCConfig, *, max_bucket: int = DEFAULT_BUCKETS[-1],
                device=None) -> int:
    """Sessions a tile for this device and geometry: ``REPRO_FLEET_TILE``
    first (a power of two in [64, 4096]); on a CUDA device the largest
    power of two whose per-session working set (streaming state, online AM
    bank, staged codes, bit-plane temporaries) fills at most 1/16 of the
    card's memory, clamped to [64, 4096]; on the CPU ``DEFAULT_TILE``.
    ``device=None`` is the card (raises without one).
    ``StreamingFleet(tile=...)`` bypasses all of this."""
    env = os.environ.get("REPRO_FLEET_TILE", "")
    if env:
        try:
            tile = int(env)
        except ValueError:
            raise ValueError(
                f"REPRO_FLEET_TILE={env!r} is not an integer; expected a "
                "power of two in [64, 4096]") from None
        if not (64 <= tile <= 4096 and tile & (tile - 1) == 0):
            raise ValueError(
                f"REPRO_FLEET_TILE={env!r} must be a power of two in "
                "[64, 4096] (the range derive_tile itself produces); use "
                "StreamingFleet(tile=...) for out-of-range experiments")
        return tile
    device = resolve_device(device)
    if device.type != "cuda":
        return DEFAULT_TILE
    limit = torch.cuda.get_device_properties(device).total_memory
    per_session = (
        cfg.dim * 4 * (1 + cfg.n_classes)          # counts + online AM bank
        + cfg.n_classes * cfg.words * 4            # class-HV rows
        + max_bucket * cfg.channels                # staged uint8 codes
        + 8 * max_bucket * cfg.words               # bit-plane temporaries
    )
    tile = max(64, min(4096, (int(limit) // 16) // max(per_session, 1)))
    return 1 << (tile.bit_length() - 1)            # floor to a power of two


@dataclass(frozen=True)
class FleetState:
    """Device state of one tile's sessions (or, from ``state``, of all)."""

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

def _on(dev: torch.device):
    """Make ``dev`` current while a tile's work is issued (kernel launches
    and events go to the current card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _host_state(state: FleetState) -> FleetState:
    """A state's leaves as host numpy arrays, packed words as uint32."""
    return FleetState(**{
        f.name: (hv.to_u32(getattr(state, f.name)) if f.name in _PACKED_LEAVES
                 else getattr(state, f.name).cpu().numpy())
        for f in fields(FleetState)})


def _copy_state(dst: FleetState, src: FleetState) -> None:
    """Write ``src``'s leaves into ``dst``'s tensors in place."""
    for f in fields(FleetState):
        d, s_ = getattr(dst, f.name), getattr(src, f.name)
        if d is not s_:
            d.copy_(s_)


def _leaves(state: FleetState) -> dict:
    """A state's leaves by name, in field order."""
    return {f.name: getattr(state, f.name) for f in fields(FleetState)}


def _clone_state(state: FleetState) -> FleetState:
    return FleetState(**{f.name: getattr(state, f.name).clone()
                         for f in fields(FleetState)})


# the per-tile operand registers a captured step or adapt reads
_REGISTERS = ("_thresholds_t", "_param_owner_t", "_density_t", "_cmask_t")


@dataclass
class _TileStatic:
    """The static tensors a tile's graphs read and write: its state, its
    registers, the staged lengths, the staged codes a bucket, the fault
    draw, and the adapt step's labels and margin."""

    state: FleetState
    regs: dict
    lens: torch.Tensor
    labels: torch.Tensor
    margin: torch.Tensor
    chunks: dict = field(default_factory=dict)
    draw: StepDraw | None = None
    draw_src: StepDraw | None = None   # the draw last copied into ``draw``


def _draw_leaves(draw: StepDraw) -> list[torch.Tensor]:
    return [t for f in fields(StepDraw) for wd in [getattr(draw, f.name)]
            if wd is not None for t in (wd.sel, wd.val) if t is not None]


@dataclass(frozen=True)
class FleetOut:
    """Raw step outputs: one row per potential frame slot (K per step)."""

    frames: torch.Tensor  # (S, K, W) int32 packed frame HVs
    scores: torch.Tensor  # (S, K, C) int32 AM scores


@dataclass(frozen=True)
class FleetRound:
    """One step's device outputs, one ``FleetOut`` a tile, plus the host
    schedule to read them: ``(session, slot)`` with ``slot <
    n_emit[session]`` are real emissions with frame index
    ``frame_base[session] + slot``."""

    tiles: tuple[FleetOut, ...]  # per-tile (tile_s, K, ...) outputs
    n_emit: np.ndarray           # (S,) frames emitted this round
    frame_base: np.ndarray       # (S,) frame index of each session's slot 0


def _fleet_step(state: FleetState, tables: torch.Tensor, owner: torch.Tensor,
                thresholds: torch.Tensor, chunk: torch.Tensor,
                lengths: torch.Tensor, chan_mask: torch.Tensor | None = None,
                *, cfg: HDCConfig, faults: FaultPlan | None = None,
                draw: StepDraw | None = None) -> tuple:
    """Advance one tile's S sessions by one padded chunk batch: chunk (S,
    t_pad, channels) uint8 raw codes, lengths (S,) int32 valid cycles,
    optional chan_mask (S, channels) int32 (1 = live).  Returns (state,
    out).

    With a fault plan, ``draw`` holds this step's masks (``faults.draw_step``
    or any other source): the bank's read is faulted next to the kernel
    launch and the carried counters' before it; the AM rows and check words
    (encoded from the clean rows) are read faulted, and with an ECC scheme
    the corrected rows score.  The step then also returns the (S, 3) int32
    [corrected, detected, uncorrectable] word counts of this read (zeros
    without a scheme)."""
    s = chunk.shape[0]
    counts_in = state.counts
    tables_xor = None
    if faults is not None:
        if faults.tables:
            tables_xor = rel_faults.xor_mask(tables, draw.tables)
        if faults.counts:
            counts_in = rel_faults.flip_counts(counts_in, draw.counts)
    seg = fleet_ops.fleet_counts_fused(tables, owner, chunk, state.filled,
                                       lengths, cfg, tables_xor=tables_xor,
                                       chan_mask=chan_mask)  # (S, K+1, D)
    n_emit = torch.div(state.filled + lengths, cfg.window,
                       rounding_mode="floor")
    # the carried accumulator belongs to the FIRST completed frame when the
    # session emits, and to the tail otherwise
    emits = n_emit > 0
    frame_counts = seg[:, :-1].clone()
    frame_counts[:, 0] += torch.where(emits[:, None], counts_in, 0)
    frames = _pack_frames(frame_counts, thresholds[:, None, None], cfg)
    ecc_counts = None
    rows, check = state.class_rows, None
    if faults is not None:
        if faults.ecc != "none":
            check = rel_ecc.encode(rows, faults.ecc)
        if faults.am:
            rows = rel_faults.flip_words(rows, draw.am)
            if check is not None:
                check = rel_faults.flip_words(check, draw.am_check)
    if check is not None:
        scores, ecc_counts = dispatch.owner_am_scores_protected(
            frames, rows, check, cfg, faults.ecc)
    else:
        scores = dispatch.owner_am_scores(frames, rows[:, None], cfg)
        if faults is not None:
            ecc_counts = torch.zeros((s, 3), dtype=torch.int32, device=chunk.device)
    sidx = torch.arange(s, device=chunk.device)
    last_slot = torch.clamp(n_emit - 1, min=0).to(torch.int64)
    new_state = replace(
        state,
        counts=seg[:, -1] + torch.where(emits[:, None], 0, counts_in),
        filled=state.filled + lengths - n_emit * cfg.window,
        frame_index=state.frame_index + n_emit,
        last_frame=torch.where(emits[:, None], frames[sidx, last_slot],
                               state.last_frame),
        last_scores=torch.where(emits[:, None], scores[sidx, last_slot],
                                state.last_scores),
        has_frame=state.has_frame | emits.to(torch.int32),
    )
    out = FleetOut(frames=frames, scores=scores)
    if faults is None:
        return new_state, out
    return new_state, out, ecc_counts


def _fleet_adapt(state: FleetState, labels: torch.Tensor, margin: float,
                 density: torch.Tensor, *, cfg: HDCConfig
                 ) -> tuple[FleetState, torch.Tensor]:
    """One gated online update for one tile's S sessions: labels (S,) the
    true class of each session's last emitted frame (-1 = no feedback),
    density (S,) float32 each session's ``class_density``.  Sessions whose
    gate fires get their counter files updated and their class rows
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


def _mask_meta(mask_h: np.ndarray) -> dict:
    """A channel-mask manifest entry: the (rows, channels) shape and the
    uint8 bytes as hex."""
    return {"shape": list(mask_h.shape), "hex": mask_h.tobytes().hex()}


def _mask_from_meta(cm: dict | None, shape: tuple[int, int]) -> np.ndarray:
    """Decode a ``_mask_meta`` entry that must have ``shape``; all-live when
    the checkpoint carries none."""
    if cm is None:
        return np.ones(shape, np.uint8)
    got = tuple(int(v) for v in cm["shape"])
    if got != tuple(shape):
        raise ValueError(
            f"checkpoint channel_mask is {got}; this fleet provisions "
            f"{tuple(shape)}")
    return np.frombuffer(bytes.fromhex(cm["hex"]), np.uint8).reshape(got).copy()


def _artifact_for(root: str, step: int, aot_dir: str | None,
                  device) -> aot_mod.AOTArtifact | None:
    """The deploy artifact a checkpoint step records (or ``aot_dir``),
    loaded and key-checked; None, with a warning, when it is stale."""
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    path = aot_dir
    if path is None:
        entry = manifest.get("aot")
        if entry is not None:
            saved = entry.get("key")
            bad = (aot_mod.stale_fields(saved, aot_mod.artifact_key(device=device))
                   if saved is not None else {})
            if bad:
                warnings.warn(
                    "checkpoint AOT entry is stale ("
                    + ", ".join(f"{k}: saved {s!r} != current {c!r}"
                                for k, (s, c) in sorted(bad.items()))
                    + "); warming up from the usual build", stacklevel=3)
            else:
                path = entry.get("path")
                if path is not None and not os.path.isabs(path):
                    path = os.path.join(root, path)
    return None if path is None else aot_mod.load_artifact(path, device=device)


class StreamingFleet:
    """S concurrent streaming seizure sessions, one step a capacity tile.

    ``pipelines`` is the patient -> trained-pipeline bank (one shared
    datapath and device, any variant; per-patient codebooks and calibrated
    thresholds welcome).  ``owners[i]`` names the patient of session ``i``.  The fleet
    runs on the bank's device: the card, or the CPU for a bank built with
    ``device="cpu"``.  ``tile`` sets the sessions a tile (default
    ``derive_tile``, capped at the fleet's size rounded up to a power of
    two); ``channel_masking`` enables ``set_channel_mask``; ``faults``
    (a ``FaultConfig``) injects bit errors and enables ``set_ber`` and
    ``ecc_stats``; ``mesh`` (a ``launch/mesh.py`` mesh over which every
    rank runs this fleet) shards the sessions, see the module docstring.
    """

    def __init__(self, pipelines: Mapping[Hashable, HDCPipeline],
                 owners: Sequence[Hashable], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 tile: int | None = None, channel_masking: bool = False,
                 faults: FaultConfig | None = None, mesh=None):
        self._cfg = dispatch.validate_bank(pipelines)
        self._masked = bool(channel_masking)
        self._faults = faults
        self._plan = None if faults is None else faults.plan()
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
        self._ctx = shd.make_ctx(mesh)
        if mesh is not None:
            from repro_torch.launch.mesh import mesh_device

            if mesh_device(mesh) != self._device:
                raise ValueError(
                    f"the bank is on {self._device} but this rank's mesh "
                    f"device is {mesh_device(mesh)}: build the bank there")
        tables, param_rows = dispatch.stack_bound_tables(pipes)
        owner_idx = np.asarray([pid_index[pid] for pid in owners], np.int64)
        self._n = len(owner_idx)
        if tile is None:
            tile = derive_tile(self._cfg, max_bucket=self._buckets[-1],
                               device=self._device)
            if not os.environ.get("REPRO_FLEET_TILE", ""):
                # capacity pads to whole tiles: a memory-derived tile is
                # capped at the fleet's size rounded up to a power of two,
                # so the phantom rows stay fewer than the sessions
                tile = min(tile,
                           max(64, 1 << (max(self._n - 1, 1).bit_length())))
        if tile <= 0:
            raise ValueError(f"tile={tile} must be positive")
        # a fleet under a quarter tile keeps its exact size
        self._np = (self._n if self._n < tile // 4
                    else -(-self._n // tile) * tile)
        if self._np > self._n:  # phantom slots take patient 0's registers
            owner_idx = np.concatenate(
                [owner_idx, np.zeros(self._np - self._n, np.int64)])
        if mesh is not None:  # one tile spanning the mesh
            tile = self._np
        self._tile_slices = [slice(i, min(i + tile, self._np))
                             for i in range(0, self._np, tile)]
        # each tile's device, and the rows of it this process holds: the
        # whole tile, or under a mesh this rank's block of the session axis
        if mesh is None:
            devs = device_mod.local_devices(self._device.type)
            if self._device in devs:  # the bank's device takes tile 0
                i = devs.index(self._device)
                devs = devs[i:] + devs[:i]
            self._session_sh = None
        else:
            devs = [self._device]
            self._session_sh = shd.sharding_for(("batch",), self._ctx, (self._np,))
            self._rank_rows = [
                shd.local_rows(self._np, self._session_sh,
                               tuple((mesh.mesh == r).nonzero()[0].tolist()))
                for r in range(mesh.size())]
        self._devs = devs
        self._tile_devs = [devs[k % len(devs)] for k in range(len(self._tile_slices))]
        self._rows_t = [self._local_rows(sl) for sl in self._tile_slices]
        self._tables = tables.contiguous()
        # the bank's pre-bound tables, one copy a device the tiles use
        self._tables_dev = {self._device: self._tables}
        for d in self._tile_devs:
            if d not in self._tables_dev:
                self._tables_dev[d] = self._tables.to(d)
        # per-slot operand registers: host mirrors and per-tile copies
        self._thr_h = np.asarray([p.cfg.temporal_threshold for p in pipes],
                                 np.int32)[owner_idx]
        self._prow_h = np.asarray(param_rows, np.int32)[owner_idx]
        self._dens_h = np.asarray([p.cfg.class_density for p in pipes],
                                  np.float32)[owner_idx]
        self._thresholds_t = self._put_tiles(self._thr_h)
        self._param_owner_t = self._put_tiles(self._prow_h)
        self._density_t = self._put_tiles(self._dens_h)
        # each session's initial class rows and counter file, on the host:
        # every fresh tile state is a copy of them
        self._class_rows0 = np.stack([hv.to_u32(p.class_hvs)
                                      for p in pipes])[owner_idx]
        # a bank with a pipeline that has no counter file cannot adapt
        if all(p.am_state is not None for p in pipes):
            self._am_counts0 = np.stack(
                [p.am_state.counts.cpu().numpy() for p in pipes])[owner_idx]
            self._am_n0 = np.stack(
                [p.am_state.n.cpu().numpy() for p in pipes])[owner_idx]
        else:
            self._am_counts0 = self._am_n0 = None
        # (start, stop, device) -> device copies of a tile's initial class
        # rows and counter file, cloned into every fresh state of that tile
        self._rows0_dev: dict[tuple, tuple] = {}
        self._state_t = self._zero_states()
        # the electrode quarantine: a host (S_prov, channels) mask, 1 =
        # live, and its per-tile int32 copies; phantom rows stay all-live
        if self._masked:
            self._cmask_h = np.ones((self._np, self._cfg.channels), np.uint8)
            self._cmask_t = self._put_tiles(self._cmask_h, torch.int32)
        # fault injection: per-tile (tile_s, 3) int32 ECC word counters on the
        # device, and each tile's stuck-mode draw (the same every round)
        if self._plan is not None:
            self._ecc_t = self._zero_ecc()
            self._stuck_draws: dict[int, StepDraw] = {}
        # host mirrors: the emission schedule is a function of (filled,
        # lengths), so the host routes results without reading the device
        self._filled_h = np.zeros((self._np,), np.int64)
        self._fidx_h = np.zeros((self._np,), np.int64)
        # per tile: (slot, bucket) -> staging buffer, and the event of the
        # last step that read it
        self._stage_t: list[dict] = [{} for _ in self._tile_slices]
        self._stage_done_t: list[dict] = [{} for _ in self._tile_slices]
        self._stage_phase = 0
        self._ragged_buf: np.ndarray | None = None
        # per tile: state changed since the last checkpoint (set by steps
        # with live cycles, adapt, slot writes and restore)
        self._dirty_t = [True] * len(self._tile_slices)
        # warm-up: per tile index its static tensors, per (tile, bucket) the
        # captured step and per tile the captured adapt, one memory pool a
        # device (a pool belongs to one card); the step shapes run eagerly
        # so far
        self._static: dict[int, _TileStatic] = {}
        self._graphs: dict[tuple[int, int], graphs.StepGraph] = {}
        self._adapt_graphs: dict[int, graphs.StepGraph] = {}
        self._pools: dict[torch.device, object] = {}
        self._shapes_seen: set[tuple] = set()

    # -- state ----------------------------------------------------------------

    def _local_rows(self, sl: slice) -> slice:
        """The rows of tile ``sl`` this process holds (all of them without a
        mesh)."""
        if self._session_sh is None:
            return sl
        r = shd.local_rows(sl.stop - sl.start, self._session_sh,
                           self._ctx.mesh.get_coordinate())
        return slice(sl.start + r.start, sl.start + r.stop)

    def _put(self, x: np.ndarray, dtype: torch.dtype | None = None,
             device: torch.device | None = None) -> torch.Tensor:
        """A copy of a host array on ``device`` (default the bank's), never
        a view of it.  On the card it goes through pinned memory and is
        queued without waiting (the pinned block is not reused before the
        copy has run)."""
        dev = self._device if device is None else device
        t = torch.from_numpy(np.array(x))
        if dtype is not None:
            t = t.to(dtype)
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def _put_tiles(self, x: np.ndarray, dtype: torch.dtype | None = None
                   ) -> list[torch.Tensor]:
        return [self._put(x[r], dtype, d) for r, d in zip(self._rows_t, self._tile_devs)]

    def _zero_state(self, k: int) -> FleetState:
        """Fresh state of capacity tile ``k`` (its rows this process holds):
        every session reset to its patient's trained bank."""
        cfg, dev, sl = self._cfg, self._tile_devs[k], self._rows_t[k]
        s = sl.stop - sl.start
        c = self._class_rows0.shape[1]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        key = (sl.start, sl.stop, dev)
        if key not in self._rows0_dev:
            # a tile's initial rows never change once its slice exists
            am = ((self._put(self._am_counts0[sl], device=dev),
                   self._put(self._am_n0[sl], device=dev))
                  if self._am_counts0 is not None else (None, None))
            self._rows0_dev[key] = (
                self._put(hv.to_i32(self._class_rows0[sl]), device=dev), *am)
        rows0, am_counts, am_n = (None if t is None else t.clone()
                                  for t in self._rows0_dev[key])
        if am_counts is None:
            am_counts, am_n = zeros(s, c, cfg.dim), zeros(s, c)
        return FleetState(counts=zeros(s, cfg.dim), filled=zeros(s),
                          frame_index=zeros(s), class_rows=rows0,
                          am_counts=am_counts, am_n=am_n,
                          last_frame=zeros(s, cfg.words),
                          last_scores=zeros(s, c), has_frame=zeros(s))

    def _zero_states(self) -> list[FleetState]:
        return [self._zero_state(k) for k in range(len(self._tile_slices))]

    def _zero_ecc(self) -> list[torch.Tensor]:
        return [torch.zeros((r.stop - r.start, 3), dtype=torch.int32, device=d)
                for r, d in zip(self._rows_t, self._tile_devs)]

    # -- mesh gathers -----------------------------------------------------------

    @property
    def mesh(self):
        """The mesh the sessions are sharded over (None: tiles on this
        process's devices)."""
        return self._ctx.mesh

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tile's rows on the host from each rank's block of them:
        one all-gather of CPU tensors over the group's CPU backend (no
        device collective).  Without a mesh, or when the blocks are
        replicated, the local rows are all of them."""
        cpu = local.detach().cpu().contiguous()
        if self._session_sh is None or self._rank_rows[0].stop == self._np:
            return cpu
        parts = [torch.empty_like(cpu) for _ in self._rank_rows]
        dist.all_gather(parts, cpu)
        first = {}
        for rank, rows in enumerate(self._rank_rows):
            first.setdefault(rows.start, rank)
        return torch.cat([parts[first[start]] for start in sorted(first)])

    def _cat_tiles(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Tile tensors (their leading dims the tiles' local rows) as one
        tensor of every row on the bank's device: the tiles on other
        devices copied over, a mesh's blocks gathered."""
        if self._session_sh is not None:
            return self._gather(tensors[0]).to(self._device)
        if len(tensors) == 1:
            return tensors[0]
        return torch.cat([t.to(self._device) for t in tensors])

    def reset(self) -> None:
        """Zero every accumulator, fill level, frame index and ECC counter,
        and restore every session's AM to its patient's trained state.
        Channel masks and the fault campaign stay."""
        self._state_t = self._zero_states()
        self._filled_h[:] = 0
        self._fidx_h[:] = 0
        self._dirty_t = [True] * len(self._tile_slices)
        if self._plan is not None:
            self._ecc_t = self._zero_ecc()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_sessions(self) -> int:
        return self._n

    @property
    def n_tiles(self) -> int:
        return len(self._tile_slices)

    @property
    def state(self) -> FleetState:
        """The whole fleet's state, tiles concatenated on the bank's device
        (a mesh's blocks gathered: every rank calls this): its leading dim
        is the provisioned capacity, and rows past ``n_sessions`` are
        phantom slots.  A warmed tile's static state is copied, so the
        value does not move with later replays."""
        tiles = [_clone_state(st) if k in self._static and
                 st is self._static[k].state else st
                 for k, st in enumerate(self._state_t)]
        return FleetState(**{
            f.name: self._cat_tiles([getattr(st, f.name) for st in tiles])
            for f in fields(FleetState)})

    @property
    def fill_levels(self) -> np.ndarray:
        """(S,) cycles accumulated toward each next (incomplete) frame."""
        return self._filled_h[:self._n].copy()

    @property
    def frame_indices(self) -> np.ndarray:
        """(S,) frames emitted so far per session."""
        return self._fidx_h[:self._n].copy()

    # -- fault injection ------------------------------------------------------

    @property
    def fault_config(self) -> FaultConfig | None:
        """The active fault campaign (None = fault-free fleet)."""
        return self._faults

    def set_ber(self, ber: float) -> None:
        """Move every enabled fault target to one bit-error rate; which
        targets, the mode and the ECC scheme are fixed at construction."""
        if self._faults is None:
            raise ValueError(
                "fleet was built without faults; pass "
                "StreamingFleet(..., faults=FaultConfig(...)) to enable "
                "fault injection")
        self._faults = self._faults.with_ber(ber)
        self._stuck_draws.clear()

    @property
    def ecc_stats(self) -> np.ndarray:
        """(S, 3) int64 per-session ECC word counts since the last ``reset``:
        [corrected, detected, uncorrectable] (detected counts every faulty
        word seen; SECDED: corrected + uncorrectable, parity only detects).
        Zeros without an ECC scheme or a fault plan."""
        if self._plan is None:
            return np.zeros((self._n, 3), np.int64)
        return self._cat_tiles(self._ecc_t).cpu().numpy().astype(np.int64)[:self._n]

    def _step_draw(self, k: int, phase: int) -> StepDraw:
        """Tile ``k``'s fault draw for the round at ``phase``, on the fleet's
        device, seeded by ``faults.step_seed``; a stuck-mode draw is the
        same every round and is kept until ``set_ber``."""
        plan = self._plan
        if plan.mode == "stuck" and k in self._stuck_draws:
            return self._stuck_draws[k]
        sl, local = self._tile_slices[k], self._rows_t[k]
        rows = (sl.stop - sl.start, self._class_rows0.shape[1], self._cfg.words)
        draw = rel_faults.draw_step(
            plan, self._faults.ber_vector(),
            rel_faults.step_seed(plan, tile=k, n_tiles=len(self._tile_slices),
                                 phase=phase),
            tables_shape=self._tables.shape, rows_shape=rows,
            counts_shape=(rows[0], self._cfg.dim), window=self._cfg.window,
            device=self._tile_devs[k])
        if local != sl:  # a mesh block: the whole tile's draw, sliced
            r = slice(local.start - sl.start, local.stop - sl.start)
            draw = StepDraw(**{
                f.name: (wd if wd is None or f.name == "tables" else
                         rel_faults.WordDraw(wd.sel[r], None if wd.val is None
                                             else wd.val[r]))
                for f in fields(StepDraw) for wd in [getattr(draw, f.name)]})
        if plan.mode == "stuck":
            self._stuck_draws[k] = draw
        return draw

    # -- channel masking ------------------------------------------------------

    @property
    def channel_masking(self) -> bool:
        """True when the step carries the channel-mask operand."""
        return self._masked

    @property
    def channel_masks(self) -> np.ndarray:
        """(S, channels) uint8 live-channel masks (1 = live); all ones for a
        fleet built without ``channel_masking``."""
        if not self._masked:
            return np.ones((self._n, self._cfg.channels), np.uint8)
        return self._cmask_h[:self._n].copy()

    def set_channel_mask(self, mask, sessions: Sequence[int] | None = None
                         ) -> None:
        """Quarantine or reinstate electrodes: ``mask`` is (S, channels), or
        (channels,) broadcast, of 0/1 (1 = live); ``sessions`` restricts the
        update to those session indices (``mask`` then (len(sessions),
        channels) or (channels,)).  Masks persist across ``reset`` and ride
        ``save``/``restore``."""
        if not self._masked:
            raise ValueError(
                "fleet was built without channel_masking; pass "
                "StreamingFleet(..., channel_masking=True) to enable "
                "electrode quarantine")
        c = self._cfg.channels
        m = np.asarray(mask)
        idx = (np.arange(self._n) if sessions is None
               else np.asarray(list(sessions), np.int64))
        if sessions is not None and (idx.size == 0 or idx.min() < 0
                                     or idx.max() >= self._n):
            raise ValueError(
                f"sessions must be indices in [0, {self._n})")
        if m.ndim == 1:
            m = np.broadcast_to(m, (idx.size, c))
        if m.shape != (idx.size, c):
            raise ValueError(
                f"mask must be ({idx.size}, {c}) or ({c},), got {m.shape}")
        if not np.isin(m, (0, 1)).all():
            raise ValueError("mask entries must be 0 or 1")
        self._cmask_h[idx] = m.astype(np.uint8)
        self._cmask_t = self._put_tiles(self._cmask_h, torch.int32)

    # -- streaming ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise AssertionError("length exceeds max bucket")  # pragma: no cover

    def _stage_buf(self, k: int, slot: int, t_pad: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Tile ``k``'s (slot, bucket) staging buffers, the codes (tile_s,
        t_pad, channels) uint8 and the lengths (tile_s,) int32, safe to
        rewrite: waits for the last step that read them.  Pinned host
        memory on the card; marked as host buffers (``_host_staging``),
        whose ``numpy()`` views are no device read."""
        key = (slot, t_pad)
        done = self._stage_done_t[k].pop(key, None)
        if done is not None:
            done.synchronize()
        if key not in self._stage_t[k]:
            sl = self._rows_t[k]
            pin = self._tile_devs[k].type == "cuda"
            bufs = (torch.zeros((sl.stop - sl.start, t_pad, self._cfg.channels),
                                dtype=torch.uint8, pin_memory=pin),
                    torch.zeros((sl.stop - sl.start,), dtype=torch.int32,
                                pin_memory=pin))
            for b in bufs:
                b._host_staging = True
            self._stage_t[k][key] = bufs
        return self._stage_t[k][key]

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
        bucketed step a tile per ``max_bucket`` cycles.  ``lengths`` is
        padded to the provisioned capacity (phantom rows 0); every tile
        steps, and a tile with no live cycles stays clean."""
        rounds: list[FleetRound] = []
        max_bucket = self._buckets[-1]
        pos = 0
        total = int(lengths.max(initial=0))
        while pos < total:
            round_len = np.clip(lengths - pos, 0, max_bucket)
            round_len32 = round_len.astype(np.int32)
            t_pad = self._bucket_for(int(round_len.max()))
            width = min(t_pad, total - pos)
            n_emit = (self._filled_h + round_len) // self._cfg.window
            phase = self._stage_phase
            slot = phase & 1
            self._stage_phase += 1
            outs = []
            for k, (sl, rows, dev) in enumerate(zip(self._tile_slices, self._rows_t,
                                                    self._tile_devs)):
                stage, lens_buf = self._stage_buf(k, slot, t_pad)
                hi = min(rows.stop, self._n)  # phantom rows: stale == masked
                if hi > rows.start:
                    stage.numpy()[:hi - rows.start, :width] = big[rows.start:hi,
                                                                  pos:pos + width]
                lens_buf.numpy()[:] = round_len32[rows]
                with _on(dev):
                    graph = self._graphs.get((k, t_pad))
                    if graph is not None:
                        fo = self._replay_step(k, t_pad, graph, stage, lens_buf, phase)
                    else:
                        fo = self._eager_step(k, t_pad, stage.to(dev, non_blocking=True),
                                              lens_buf.to(dev, non_blocking=True), phase)
                    if dev.type == "cuda":  # the staging slot is free once this step has run
                        done = torch.cuda.Event()
                        done.record()
                        self._stage_done_t[k][(slot, t_pad)] = done
                if round_len[sl].any():
                    self._dirty_t[k] = True
                outs.append(fo)
            # rounds expose real sessions only: phantom rows never emit
            rounds.append(FleetRound(tiles=tuple(outs), n_emit=n_emit[:self._n],
                                     frame_base=self._fidx_h[:self._n].copy()))
            self._filled_h += round_len - n_emit * self._cfg.window
            self._fidx_h += n_emit
            pos += max_bucket
        return rounds

    def _eager_step(self, k: int, t_pad: int, chunk: torch.Tensor,
                    lens: torch.Tensor, phase: int) -> FleetOut:
        """Tile ``k``'s step as eager launches (a shape first run here is
        logged in ``graphs.EAGER_LOG``)."""
        sl = self._rows_t[k]
        self._note_eager("step", sl.stop - sl.start, t_pad)
        args = (self._state_t[k], self._tables_dev[self._tile_devs[k]],
                self._param_owner_t[k],
                self._thresholds_t[k], chunk, lens,
                self._cmask_t[k] if self._masked else None)
        if self._plan is None:
            self._state_t[k], fo = _fleet_step(*args, cfg=self._cfg)
        else:
            self._state_t[k], fo, ecc_c = _fleet_step(
                *args, cfg=self._cfg, faults=self._plan,
                draw=self._step_draw(k, phase))
            self._ecc_t[k] += ecc_c
        return fo

    def _note_eager(self, *shape) -> None:
        """Log a (kind, tile, bucket) shape the first time it runs eagerly:
        the counterpart of a compile (``analysis/guards.no_recompiles``)."""
        if shape not in self._shapes_seen:
            self._shapes_seen.add(shape)
            graphs.EAGER_LOG.append(self._aot_name(*shape))

    def _replay_step(self, k: int, t_pad: int, graph: graphs.StepGraph,
                     stage: torch.Tensor, lens_buf: torch.Tensor,
                     phase: int) -> FleetOut:
        """Tile ``k``'s step as a replay of its captured graph: the staged
        inputs are copied into the static ones (queued before the replay),
        the state is updated in place, and the round's outputs are copied
        out of the graph's."""
        st = self._bind_static(k)
        st.chunks[t_pad].copy_(stage, non_blocking=True)
        st.lens.copy_(lens_buf, non_blocking=True)
        if self._plan is not None:
            draw = self._step_draw(k, phase)
            if draw is not st.draw_src:  # a stuck draw is copied once
                for dst, src in zip(_draw_leaves(st.draw), _draw_leaves(draw)):
                    dst.copy_(src)
                st.draw_src = draw
        out = graph.replay()
        if self._plan is not None:
            self._ecc_t[k] += out[2]
        return FleetOut(frames=out[0].clone(), scores=out[1].clone())

    def push_raw(self, chunks: Sequence) -> list[FleetRound]:
        """Feed one (t_i, channels) uint8 chunk per session; returns one
        ``FleetRound`` per step without waiting for the device."""
        if len(chunks) != self._n:
            raise ValueError(
                f"push needs one chunk per session ({self._n}), got {len(chunks)}")
        arrs, real_lengths = self._validate(chunks)
        if int(real_lengths.max(initial=0)) == 0:
            return []
        lengths = np.zeros((self._np,), np.int64)
        lengths[:self._n] = real_lengths
        return self._rounds(self._pack(arrs, real_lengths), lengths)

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
        lens = np.zeros((self._np,), np.int64)
        if lengths is None:
            lens[:self._n] = t
        else:
            ll = np.asarray(lengths, np.int64)
            if ll.shape != (self._n,) or ll.min(initial=0) < 0 or \
                    ll.max(initial=0) > t:
                raise ValueError(
                    f"lengths must be ({self._n},) ints in [0, {t}]")
            lens[:self._n] = ll
        if t == 0 or int(lens.max(initial=0)) == 0:
            return []
        return self._rounds(batch, lens)

    def push_codes(self, batch, lengths: Sequence[int] | None = None
                   ) -> list[list[FrameDecision]]:
        """``push`` for a pre-stacked (S, t, channels) code batch."""
        return self.collect_decisions(self.push_codes_raw(batch, lengths))

    def _round_outputs(self, rounds: Sequence[FleetRound]) -> list[list]:
        """Each round's per-tile (frames uint32, scores) host arrays of the
        tile's every row; ``None`` for a tile that emitted nothing.  Under a
        mesh the rounds' blocks are gathered in one collective."""
        if self._session_sh is None:
            return [[None if not r.n_emit[sl].any() else
                     (hv.to_u32(fo.frames), fo.scores.cpu().numpy())
                     for sl, fo in zip(self._tile_slices, r.tiles)] for r in rounds]
        if not rounds:
            return []
        w = self._cfg.words
        local = [torch.cat([r.tiles[0].frames, r.tiles[0].scores], -1) for r in rounds]
        full = self._gather(torch.cat([t.flatten(1) for t in local], 1))
        out, at = [], 0
        for t in local:
            n = t[0].numel()
            both = full[:, at:at + n].reshape(-1, *t.shape[1:]).numpy()
            at += n
            out.append([(both[..., :w].view(np.uint32), both[..., w:])])
        return out

    def collect_decisions(self, rounds: Sequence[FleetRound]
                          ) -> list[list[FrameDecision]]:
        """Materialise per-session FrameDecision lists from raw rounds (the
        only place the fleet waits for the device; under a mesh every rank
        calls it and gets every session's decisions)."""
        out: list[list[FrameDecision]] = [[] for _ in range(self._n)]
        rounds = [r for r in rounds if r.n_emit.any()]
        for r, host in zip(rounds, self._round_outputs(rounds)):
            for sl, tile_out in zip(self._tile_slices, host):
                if tile_out is None:
                    continue
                ne = r.n_emit[sl]
                frames, scores = tile_out
                preds = np.argmax(scores, axis=-1)
                for i in np.nonzero(ne)[0]:
                    g = sl.start + int(i)
                    base = int(r.frame_base[g])
                    out[g].extend(
                        FrameDecision(frame_index=base + k, scores=scores[i, k],
                                      prediction=int(preds[i, k]),
                                      frame_hv=frames[i, k])
                        for k in range(int(ne[i])))
        return out

    def push(self, chunks: Sequence) -> list[list[FrameDecision]]:
        """Feed one (t_i, channels) uint8 chunk per session (lengths may
        differ, 0 included); returns each session's completed decisions."""
        return self.collect_decisions(self.push_raw(chunks))


    # -- instrumentation ------------------------------------------------------

    def stage_probes(self, batch) -> dict[str, tuple]:
        """Per-stage probes of one steady push round (the reference's, for a
        fleet benchmark's breakdown rows): ``batch`` is one (S, t, channels)
        uint8 code round (0 < t <= the largest bucket).  Returns ``{stage:
        (fn, scale)}``: ``fn()`` runs that stage once on tile 0 and returns
        its output (``ingest``: the host side of one round over every
        tile's staging buffers, returning None); ``scale`` is the tile
        count (1 for ``ingest``).  Each fn has run once before it is
        returned.  The stages are the plain datapath's: ``spatial``
        (``dispatch.owner_spatial_codes``, masked on a masked fleet),
        ``temporal`` (``fleet_counts``' plain bit-plane path) and ``am``
        (threshold or majority pack, then ``owner_am_scores`` against a
        clone of tile 0's class rows).  A fleet on the card raises: its
        kernel fuses gather, bundle, transpose and counters in one launch,
        so these stage times would describe a datapath it never runs (the
        card's stage shares come from the profiler)."""
        if any(d.type == "cuda" for d in self._tile_devs):
            raise ValueError(
                "stage_probes breaks the step into the plain stages; this "
                "fleet runs the fused CUDA kernel on the card: probe a CPU "
                "fleet, or read the stage shares from the profiler")
        cfg = self._cfg
        batch = np.asarray(batch, np.uint8)
        t = batch.shape[1]
        if not 0 < t <= self._buckets[-1]:
            raise ValueError(f"stage_probes needs one round, 0 < t <= {self._buckets[-1]}")
        rows, dev = self._rows_t[0], self._tile_devs[0]
        tile_s = rows.stop - rows.start
        tables, owner = self._tables_dev[dev], self._param_owner_t[0]
        thresholds = self._thresholds_t[0]
        class_rows = self._state_t[0].class_rows.clone()
        tile_batch = np.zeros((tile_s, t, cfg.channels), np.uint8)
        hi = min(rows.stop, self._n)
        if hi > rows.start:
            tile_batch[:hi - rows.start] = batch[rows.start:hi]
        chunk = self._put(tile_batch, device=dev)
        filled = self._put(np.zeros(tile_s, np.int32), device=dev)
        lengths = self._put(np.full(tile_s, t, np.int32), device=dev)
        mask = self._cmask_t[0] if self._masked else None

        def spatial():
            return dispatch.owner_spatial_codes(tables, owner, chunk, cfg, mask)

        words = spatial()

        def temporal():
            return fleet_ops.fleet_counts(words, filled, lengths, cfg)

        seg = temporal()

        def am():
            if cfg.variant == "dense":
                frames = hv.majority_pack(seg[:, :-1], cfg.window, cfg.dim)
            else:
                frames = hv.threshold_pack(seg[:, :-1], thresholds[:, None, None])
            return dispatch.owner_am_scores(frames, class_rows[:, None], cfg)

        am()
        t_bucket = self._bucket_for(t)

        def ingest():  # the host side of one round: every tile's staging writes
            for k, r in enumerate(self._rows_t):
                stage, lens = self._stage_buf(k, 0, t_bucket)
                top = min(r.stop, self._n)
                if top > r.start:
                    stage.numpy()[:top - r.start, :t] = batch[r.start:top]
                lens.numpy()[:] = t

        ingest()
        n_tiles = self.n_tiles
        return {"ingest": (ingest, 1), "spatial": (spatial, n_tiles),
                "temporal": (temporal, n_tiles), "am": (am, n_tiles)}

    # -- online adaptation ----------------------------------------------------

    @property
    def class_rows(self) -> np.ndarray:
        """(S, C, W) uint32 per-session (possibly adapted) class HV rows."""
        return hv.to_u32(self._cat_tiles([st.class_rows for st in self._state_t]))[:self._n]

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
        full = np.full((self._np,), -1, np.int64)  # phantoms: no feedback
        full[:self._n] = lab
        applied = []
        for k, (sl, dev) in enumerate(zip(self._rows_t, self._tile_devs)):
            with _on(dev):
                graph = self._adapt_graphs.get(k)
                if graph is not None:
                    st = self._bind_static(k)
                    st.labels.copy_(self._put(full[sl], device=dev))
                    st.margin.fill_(float(np.float32(margin)))
                    app = graph.replay()[0]
                else:
                    self._note_eager("adapt", sl.stop - sl.start)
                    self._state_t[k], app = _fleet_adapt(
                        self._state_t[k], self._put(full[sl], device=dev), margin,
                        self._density_t[k], cfg=self._cfg)
            self._dirty_t[k] = True
            applied.append(app.to(torch.int32))
        return self._cat_tiles(applied).cpu().numpy()[:self._n] != 0

    # -- warm-up: CUDA graphs and deploy artifacts ----------------------------

    @property
    def compile_count(self) -> int:
        """Step programs prepared so far (<= buckets x tiles): the step
        shapes run eagerly plus the steps captured by ``warmup``."""
        return sum(sh[0] == "step" for sh in self._shapes_seen) + self.aot_count

    @property
    def aot_count(self) -> int:
        """Steps captured as CUDA graphs by ``warmup`` (adapts aside)."""
        return len(self._graphs)

    def _aot_sig(self) -> str:
        """Digest of what selects this fleet's step beyond its shapes: the
        datapath config, the fault plan, channel masking, the device type
        and the bank's geometry.  Rides in every entry name."""
        h = hashlib.sha256()
        h.update(repr(self._cfg).encode())
        h.update(repr(self._plan).encode())
        h.update(str(self._masked).encode())
        h.update(self._device.type.encode())
        h.update(str(tuple(self._tables.shape)).encode())
        return h.hexdigest()[:10]

    def _aot_name(self, kind: str, tile_s: int, t_pad: int | None = None) -> str:
        base = (f"fleet.{self._cfg.variant}.{self._device.type}"
                f"{'.faulted' if self._plan is not None else ''}"
                f"{'.masked' if self._masked else ''}.s{tile_s}")
        mid = f".t{t_pad}" if kind == "step" else ""
        return f"{base}{mid}.{kind}.{self._aot_sig()}"

    def aot_entries(self, buckets: Sequence[int] | None = None
                    ) -> list[aot_mod.AOTEntry]:
        """This fleet's warm-up set: one step a (distinct tile shape,
        bucket) and, when the bank can adapt, one adapt a tile shape."""
        out: list[aot_mod.AOTEntry] = []
        seen: set[tuple] = set()
        for sl in self._rows_t:
            tile_s = sl.stop - sl.start
            for b in buckets or self._buckets:
                if ("step", tile_s, b) not in seen:
                    seen.add(("step", tile_s, b))
                    out.append(aot_mod.AOTEntry(self._aot_name("step", tile_s, b),
                                                "step", tile_s, b))
            if self._am_counts0 is not None and ("adapt", tile_s) not in seen:
                seen.add(("adapt", tile_s))
                out.append(aot_mod.AOTEntry(self._aot_name("adapt", tile_s),
                                            "adapt", tile_s))
        return out

    def save_aot(self, path: str) -> dict:
        """Write this fleet's deploy artifact at ``path``: the built kernel
        library and the entry names (``runtime/aot.py``); returns the
        manifest.  Run at deploy time (``launch/serve.py compile``); a mesh
        fleet has no artifact (its ranks step eagerly) and raises."""
        if self.mesh is not None:
            raise ValueError("a deploy artifact warms one process's tiles; "
                             "build it from a fleet without a mesh")
        return aot_mod.save_artifact(
            path, self.aot_entries(), key=aot_mod.artifact_key(device=self._device))

    def _graph_pool(self, dev: torch.device):
        if dev not in self._pools:  # one pool a device for this fleet's graphs
            with _on(dev):
                self._pools[dev] = torch.cuda.graph_pool_handle()
        return self._pools[dev]

    def _tile_static(self, k: int) -> _TileStatic:
        """Tile ``k``'s static tensors, made (from its current state and
        registers) at its first capture and bound to it."""
        st = self._static.get(k)
        if st is None:
            sl = self._rows_t[k]
            s, dev = sl.stop - sl.start, self._tile_devs[k]
            regs = {name: getattr(self, name)[k].clone() for name in _REGISTERS
                    if name != "_cmask_t" or self._masked}
            st = _TileStatic(
                state=_clone_state(self._state_t[k]), regs=regs,
                lens=torch.zeros((s,), dtype=torch.int32, device=dev),
                labels=torch.full((s,), -1, dtype=torch.int64, device=dev),
                margin=torch.zeros((), dtype=torch.float32, device=dev))
            if self._plan is not None:
                draw = self._step_draw(k, self._stage_phase)
                st.draw = rel_faults.StepDraw(**{
                    f.name: None if wd is None else rel_faults.WordDraw(
                        wd.sel.clone(), None if wd.val is None else wd.val.clone())
                    for f in fields(StepDraw) for wd in [getattr(draw, f.name)]})
            self._static[k] = st
        return self._bind_static(k)

    def _bind_static(self, k: int) -> _TileStatic:
        """Make tile ``k``'s static tensors current: a state or register
        that was replaced since (eager adapt, restore, reset, slot writes,
        masks) is copied in, and the static tensor takes its place."""
        st = self._static[k]
        if self._state_t[k] is not st.state:
            _copy_state(st.state, self._state_t[k])
            self._state_t[k] = st.state
        for name, reg in st.regs.items():
            regs = getattr(self, name)
            if regs[k] is not reg:
                reg.copy_(regs[k])
                regs[k] = reg
        return st

    def _step_program(self, k: int, t_pad: int) -> graphs.Program:
        """Tile ``k``'s step at bucket ``t_pad`` over its static tensors:
        what ``warmup`` captures and the audit (``analysis/audit.py``)
        reads.  Runs on a CPU fleet too; the tile's device must be current
        while the body runs."""
        st = self._tile_static(k)
        sl, dev = self._rows_t[k], self._tile_devs[k]
        s = sl.stop - sl.start
        chunk = st.chunks.get(t_pad)
        if chunk is None:
            chunk = st.chunks[t_pad] = torch.zeros(
                (s, t_pad, self._cfg.channels), dtype=torch.uint8, device=dev)
        extra = {} if self._plan is None else {"faults": self._plan, "draw": st.draw}
        tables = self._tables_dev[dev]

        def run(state):
            return _fleet_step(state, tables, st.regs["_param_owner_t"],
                               st.regs["_thresholds_t"], chunk, st.lens,
                               st.regs.get("_cmask_t"), cfg=self._cfg, **extra)

        def body():
            new_state, fo, *ecc = run(st.state)
            _copy_state(st.state, new_state)
            return (fo.frames, fo.scores, *ecc)

        inputs = {"codes": chunk, "lengths": st.lens}
        if st.draw is not None:
            inputs.update((f"draw{i}", t) for i, t in enumerate(_draw_leaves(st.draw)))
        return graphs.Program(
            name=self._aot_name("step", s, t_pad), kind="step", body=body,
            state=_leaves(st.state), inputs=inputs,
            eager=lambda leaves: _leaves(run(FleetState(**leaves))[0]),
            counted=(fleet_ops.fleet_counts_kernel,))

    def _adapt_program(self, k: int) -> graphs.Program:
        """Tile ``k``'s adapt over its static tensors (labels and margin as
        static inputs), as ``_step_program``."""
        st = self._tile_static(k)
        sl = self._rows_t[k]

        def run(state):
            return _fleet_adapt(state, st.labels, st.margin,
                                st.regs["_density_t"], cfg=self._cfg)

        def body():
            new_state, applied = run(st.state)
            _copy_state(st.state, new_state)
            return (applied,)

        return graphs.Program(
            name=self._aot_name("adapt", sl.stop - sl.start), kind="adapt", body=body,
            state=_leaves(st.state), inputs={"labels": st.labels, "margin": st.margin},
            eager=lambda leaves: _leaves(run(FleetState(**leaves))[0]))

    def _capture_step(self, k: int, t_pad: int) -> graphs.StepGraph:
        """Capture tile ``k``'s step at bucket ``t_pad`` (on the tile's
        device, current while this runs)."""
        g = graphs.capture_program(self._step_program(k, t_pad),
                                   self._graph_pool(self._tile_devs[k]))
        self._graphs[(k, t_pad)] = g
        return g

    def _capture_adapt(self, k: int) -> graphs.StepGraph:
        """Capture tile ``k``'s adapt (on the tile's device, current while
        this runs)."""
        g = graphs.capture_program(self._adapt_program(k),
                                   self._graph_pool(self._tile_devs[k]))
        self._adapt_graphs[k] = g
        return g

    def programs(self) -> list[tuple[graphs.Program, graphs.StepGraph | None]]:
        """Every tile's step at every bucket and, when the bank can adapt,
        its adapt, as ``warmup`` builds them, each with its captured graph
        (None before ``warmup``).  Builds the tiles' static tensors; a
        mesh fleet, which steps eagerly on each rank, has none and raises."""
        if self.mesh is not None:
            raise ValueError("a mesh fleet's ranks step eagerly: it has no warm-up "
                             "programs")
        out = []
        for k in range(len(self._rows_t)):
            for b in self._buckets:
                out.append((self._step_program(k, b), self._graphs.get((k, b))))
            if self._am_counts0 is not None:
                out.append((self._adapt_program(k), self._adapt_graphs.get(k)))
        return out

    def warmup(self, *, aot: aot_mod.AOTArtifact | None = None,
               buckets: Sequence[int] | None = None) -> dict[str, int]:
        """Capture every tile's step at every bucket (and its adapt) as a
        CUDA graph before traffic arrives; later rounds replay them.

        The kernel library comes from ``aot`` (a loaded deploy artifact: no
        ``nvcc``) or else from the usual build.  A capture whose entry the
        artifact names counts as ``loaded``, any other as ``compiled``;
        tiles and buckets already captured are ``skipped``.  Each capture
        first runs its step eagerly on copies of the state, then captures.
        On the CPU nothing is captured and every entry is ``skipped``; under
        a mesh nothing is captured either, with a warning (the reference's
        mesh fleets skip their AOT path too), and every count is 0.
        Returns ``{"loaded", "compiled", "skipped"}``."""
        stats = {"loaded": 0, "compiled": 0, "skipped": 0}
        if self.mesh is not None:
            warnings.warn("StreamingFleet.warmup: a mesh fleet's ranks step "
                          "eagerly (no CUDA graphs)", stacklevel=2)
            return stats
        if self._device.type != "cuda":
            stats["skipped"] = len(self.aot_entries(buckets))
            return stats
        aot_mod.load_library(aot)

        def count(name: str) -> None:
            stats["loaded" if aot is not None and name in aot else "compiled"] += 1

        for k, dev in enumerate(self._tile_devs):
            with _on(dev):
                for b in buckets or self._buckets:
                    if (k, b) in self._graphs:
                        stats["skipped"] += 1
                        continue
                    count(self._capture_step(k, b).name)
                if self._am_counts0 is not None:
                    if k in self._adapt_graphs:
                        stats["skipped"] += 1
                    else:
                        count(self._capture_adapt(k).name)
        return stats

    @property
    def capture_ms(self) -> dict[str, float]:
        """Host ms of each capture, by graph (tile, bucket or adapt)."""
        out = {f"tile{k}.t{b}": g.capture_ms for (k, b), g in self._graphs.items()}
        out.update({f"tile{k}.adapt": g.capture_ms
                    for k, g in self._adapt_graphs.items()})
        return out

    @classmethod
    def from_artifact(cls, pipelines: Mapping[Hashable, HDCPipeline],
                      owners: Sequence[Hashable], root: str, *,
                      step: int | None = None, aot_dir: str | None = None,
                      warm: bool = True, **fleet_kwargs) -> "StreamingFleet":
        """Worker restart: build a fleet, warm it from the deploy artifact
        its checkpoint records (``save(..., aot_dir=...)``; ``aot_dir``
        overrides the recorded path) and restore the checkpointed state.
        A stale or missing artifact (other torch, CUDA, card or kernel
        sources) warns and warms from the usual build: decisions are the
        same either way, only the start-up time differs."""
        fleet = cls(pipelines, owners, **fleet_kwargs)
        if step is None:
            step = ckpt.latest_step(root)
            if step is None:
                raise FileNotFoundError(f"no fleet checkpoint under {root!r}")
        art = _artifact_for(root, step, aot_dir, fleet.device)
        if warm:
            fleet.warmup(aot=art)
        fleet.restore(root, step)
        return fleet

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

    @staticmethod
    def _digest(operands) -> str:
        """sha256 over each array's (dtype, shape) and bytes, 16 hex digits."""
        h = hashlib.sha256()
        for a in operands:
            arr = np.ascontiguousarray(a)
            h.update(str((arr.dtype.str, arr.shape)).encode())
            h.update(arr.tobytes())
        return h.hexdigest()[:16]

    def _bank_fingerprint(self) -> str:
        """Digest of what a saved state is only valid against: the pre-bound
        tables and, for every provisioned slot, its table row, threshold,
        class density, initial class rows and counter file.  Packed words
        are hashed as uint32."""
        operands = [hv.to_u32(self._tables), self._prow_h, self._thr_h,
                    self._dens_h, self._class_rows0]
        if self._am_counts0 is not None:
            operands += [self._am_counts0, self._am_n0]
        return self._digest(operands)

    def save(self, root: str, step: int | None = None,
             aot_dir: str | None = None) -> str:
        """Checkpoint the whole fleet state (streaming accumulators and
        online AM banks, ``state``'s padded rows) under ``root`` with the
        checkpoint module's atomic rename; ``step`` defaults to one past
        the latest.  Packed words are saved as uint32; channel masks ride
        the manifest meta.  ``aot_dir`` also writes the deploy artifact
        there (``save_aot``) and records its path and key as the
        manifest's ``aot`` entry (a relative path resolves against
        ``root``).  Under a mesh every rank calls it: the blocks are
        gathered and rank 0 writes.  Returns the checkpoint directory."""
        if step is None:
            latest = ckpt.latest_step(root)
            step = 0 if latest is None else latest + 1
        meta = self._meta()
        if self._masked:
            # outside the _meta() comparison: a fleet without masking
            # restores the checkpoint
            meta["channel_mask"] = _mask_meta(self._cmask_h[:self._n])
        return ckpt.save(root, step, _host_state(self.state), meta=meta,
                         aot=self._save_aot_entry(aot_dir))

    def _save_aot_entry(self, aot_dir: str | None) -> dict | None:
        if aot_dir is None:
            return None
        self.save_aot(aot_dir)
        return {"path": aot_dir, "key": aot_mod.artifact_key(device=self._device)}

    def restore(self, root: str, step: int | None = None) -> int:
        """Restore a ``save``d state into this fleet (the same bank and
        session count); pushes continue mid-stream from the restored fill
        levels, and a checkpoint without masks restores all-live.  Returns
        the step."""
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
        # the full arrays on the host (every rank reads them), then each
        # tile's rows this process holds (under a mesh its block) on the
        # tile's device
        host = ckpt.restore(root, step, like=FleetState(**{f.name: torch.empty(
            (self._np, *getattr(self._state_t[0], f.name).shape[1:]),
            dtype=torch.int32) for f in fields(FleetState)}))
        self._state_t = [FleetState(**{f.name: getattr(host, f.name)[rows].to(dev)
                                       for f in fields(FleetState)})
                         for rows, dev in zip(self._rows_t, self._tile_devs)]
        self._filled_h = host.filled.numpy().astype(np.int64)
        self._fidx_h = host.frame_index.numpy().astype(np.int64)
        self._dirty_t = [True] * len(self._tile_slices)
        if self._masked:
            self._cmask_h[:] = 1
            self._cmask_h[:self._n] = _mask_from_meta(
                meta.get("channel_mask"), (self._n, self._cfg.channels))
            self._cmask_t = self._put_tiles(self._cmask_h, torch.int32)
        return step
