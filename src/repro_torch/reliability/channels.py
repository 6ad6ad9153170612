"""Electrode-fault models and online channel-health quarantine (a numpy
copy of ``repro.reliability.channels``; the port imports nothing of the
reference package, and this module keeps its behaviour, seeds and event
logs bit for bit).

A failing electrode (flat, railed, line noise, intermittent, gain drift) is
chronic iEEG's dominant fault.  The spatial bundle is a symmetric OR or
threshold over channel HVs, so a known-bad channel is a maskable term, not
a retrain.  The module has three pieces:

* **fault models** at two levels: raw-signal injection for ``data/ieeg.py``
  records (all five ``CHANNEL_FAULT_TYPES``, through ``make_record``'s
  ``signal_transform`` hook) and LBP-code-level injection for fleet-scale
  sweeps (``CODE_FAULT_TYPES``, everything but ``gain_drift``: LBP's
  sign-of-difference code does not see a constant gain);
* ``ChannelHealthMonitor``, which flags dead or railed channels from
  per-channel code statistics alone (entropy collapse, stuck-code runs)
  with hysteresis and an event log;
* ``FleetChannelMonitor``, one monitor per fleet session, emitting the
  (S, C) masks ``StreamingFleet(channel_masking=True).set_channel_mask``
  takes.

``channel_stats`` is a Python loop over channels on the host, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data import ieeg

# signal-level kinds; CODE_FAULT_TYPES is the subset observable in the
# LBP code domain (gain drift is amplitude-only and LBP codes are
# amplitude-invariant, so it has no code-level model — by design)
CHANNEL_FAULT_TYPES = ("dead", "saturated", "line_noise", "dropout",
                       "gain_drift")
CODE_FAULT_TYPES = ("dead", "saturated", "line_noise", "dropout")

LINE_HZ = 50.0  # mains interference frequency of the line_noise model


# ---------------------------------------------------------------------------
# signal-level electrode fault models (raw (channels, T) float signal)
# ---------------------------------------------------------------------------

def inject_signal_fault(x: np.ndarray, channel: int, kind: str,
                        rng: np.random.Generator, *, fs: int = ieeg.FS,
                        start: int = 0) -> np.ndarray:
    """Return a copy of the (channels, T) raw signal with one electrode
    fault injected on ``channel`` from sample ``start`` on.

    ``dead``       — the contact detaches: the channel holds its last value
                     (flat line; LBP codes collapse to 0).
    ``saturated``  — the amplifier rails: hard clip at a rail well inside
                     the signal's dynamic range, so the waveform slams
                     between the rails (long stuck-code runs).
    ``line_noise`` — a failing reference couples in mains: a 50 Hz
                     sinusoid an order of magnitude above the signal
                     dominates the first differences (periodic codes).
    ``dropout``    — intermittent contact: random flat segments (geometric
                     lengths, ~half duty cycle) interleave with the true
                     signal.
    ``gain_drift`` — electrode impedance drifts: a slow multiplicative
                     gain ramp (2x over the fault span).  LBP coding is
                     invariant to constant gain and a slow ramp perturbs
                     only near-tie first differences, so the channel's
                     code statistics stay healthy — the model exists to
                     DEMONSTRATE that robustness.
    """
    if kind not in CHANNEL_FAULT_TYPES:
        raise ValueError(f"kind={kind!r} must be one of "
                         f"{CHANNEL_FAULT_TYPES}")
    x = np.array(x, dtype=np.float32, copy=True)
    ch = x[channel]
    t = ch.shape[0]
    if not 0 <= start < t:
        raise ValueError(f"start={start} outside [0, {t})")
    span = t - start
    if kind == "dead":
        ch[start:] = ch[start]
    elif kind == "saturated":
        rail = 0.25 * float(np.std(ch) or 1.0)
        ch[start:] = np.clip(ch[start:], -rail, rail)
    elif kind == "line_noise":
        amp = 10.0 * float(np.std(ch) or 1.0)
        tt = np.arange(start, t, dtype=np.float32) / fs
        ch[start:] = ch[start:] + amp * np.sin(
            2 * np.pi * LINE_HZ * tt, dtype=np.float32)
    elif kind == "dropout":
        pos, flat = start, False
        while pos < t:
            seg = int(rng.geometric(1.0 / 64.0))
            if flat:
                ch[pos:pos + seg] = ch[pos - 1] if pos else ch[0]
            pos += seg
            flat = not flat
    else:  # gain_drift
        ramp = 1.0 + np.arange(span, dtype=np.float32) / max(span - 1, 1)
        ch[start:] = ch[start:] * ramp
    x[channel] = ch
    return x


def signal_fault_transform(faults: list[tuple[int, str]], *,
                           fs: int = ieeg.FS, start: int = 0):
    """Build the ``ieeg.make_record(signal_transform=...)`` hook that
    injects ``[(channel, kind), ...]`` electrode faults into a record's
    raw signal just before LBP coding — per-channel, per-record fault
    injection through the exact production preprocessing."""
    for ch, kind in faults:
        if kind not in CHANNEL_FAULT_TYPES:
            raise ValueError(f"kind={kind!r} must be one of "
                             f"{CHANNEL_FAULT_TYPES}")

    def transform(x, rng):
        for ch, kind in faults:
            x = inject_signal_fault(x, ch, kind, rng, fs=fs, start=start)
        return x
    return transform


# ---------------------------------------------------------------------------
# code-level electrode fault models ((..., T, C) uint8 LBP codes)
# ---------------------------------------------------------------------------

def inject_code_fault(codes: np.ndarray, channel: int, kind: str,
                      rng: np.random.Generator, *, bits: int = 6,
                      fs: int = ieeg.FS, start: int = 0) -> np.ndarray:
    """Return a copy of the (..., T, C) uint8 LBP codes with ``channel``
    replaced by the code stream the corresponding SIGNAL fault produces —
    the fleet-scale injection point (no raw signal round-trip per sweep).

    ``dead`` is code 0 (a flat line has no positive first differences);
    ``saturated`` alternates geometric-length runs of 0 (parked at a rail)
    and ``2**bits - 1`` (slamming upward between rails); ``line_noise`` is
    the exact LBP coding of a dominant 50 Hz sinusoid (periodic over
    fs / 50 samples); ``dropout`` interleaves flat (code 0) segments with
    the channel's true codes.  ``gain_drift`` has no code-level model —
    gain barely moves the code statistics (see inject_signal_fault) —
    and raises.
    """
    if kind not in CODE_FAULT_TYPES:
        raise ValueError(
            f"kind={kind!r} must be one of {CODE_FAULT_TYPES} "
            "(gain_drift is signal-only: LBP codes are amplitude-"
            "invariant, see inject_signal_fault)")
    codes = np.array(codes, copy=True)
    t = codes.shape[-2]
    if not 0 <= start < t:
        raise ValueError(f"start={start} outside [0, {t})")
    span = t - start
    full = np.uint8((1 << bits) - 1)
    if kind == "dead":
        codes[..., start:, channel] = 0
    elif kind == "saturated":
        stream = np.zeros(span, np.uint8)
        pos, high = 0, False
        while pos < span:
            seg = int(rng.geometric(1.0 / 32.0))
            stream[pos:pos + seg] = full if high else 0
            pos += seg
            high = not high
        codes[..., start:, channel] = stream
    elif kind == "line_noise":
        tt = np.arange(start, t + bits, dtype=np.float32) / fs
        wave = np.sin(2 * np.pi * LINE_HZ * tt, dtype=np.float32)
        codes[..., start:, channel] = ieeg.lbp_codes_np(wave, bits)[:span]
    else:  # dropout
        pos, flat = start, False
        while pos < t:
            seg = int(rng.geometric(1.0 / 64.0))
            if flat:
                codes[..., pos:pos + seg, channel] = 0
            pos += seg
            flat = not flat
    return codes


def degrade_batch(batch: np.ndarray, n_failed: int, kind: str, *,
                  seed: int = 0, bits: int = 6
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Fleet-sweep helper: fail ``n_failed`` channels per session (chosen
    independently per session) in an (S, T, C) code batch.

    Returns ``(faulted_batch, mask)`` where ``mask`` is the (S, C) uint8
    LIVE mask (0 on the faulted channels) — exactly what
    ``StreamingFleet.set_channel_mask`` takes for the oracle-quarantine
    arm of the degradation sweep."""
    s, _, c = batch.shape
    if not 0 <= n_failed <= c:
        raise ValueError(f"n_failed={n_failed} outside [0, {c}]")
    rng = np.random.default_rng(seed)
    out = np.array(batch, copy=True)
    mask = np.ones((s, c), np.uint8)
    for i in range(s):
        for ch in rng.choice(c, size=n_failed, replace=False):
            out[i] = inject_code_fault(out[i], int(ch), kind, rng, bits=bits)
            mask[i, ch] = 0
    return out, mask


# ---------------------------------------------------------------------------
# online channel-health monitoring (code statistics only)
# ---------------------------------------------------------------------------

def channel_stats(codes: np.ndarray, *, n_codes: int = 64
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel health statistics of one (T, C) code block.

    Returns ``(entropy, stuck)``: the Shannon entropy (bits) of each
    channel's code histogram and its longest same-code run.  Healthy
    broadband iEEG spreads LBP codes over the alphabet (entropy well
    above 1 bit, short runs); a dead/railed electrode collapses to a
    handful of codes (entropy -> 0) and/or parks on one code for long
    runs.  Line noise keeps runs short but still collapses the histogram
    onto the few codes of its periodic pattern."""
    t, c = codes.shape
    ent = np.zeros(c, np.float64)
    stuck = np.zeros(c, np.int64)
    for ch in range(c):
        col = codes[:, ch]
        hist = np.bincount(col, minlength=n_codes).astype(np.float64)
        p = hist[hist > 0] / t
        ent[ch] = float(-(p * np.log2(p)).sum())
        changes = np.nonzero(np.diff(col))[0]
        edges = np.concatenate([[-1], changes, [t - 1]])
        stuck[ch] = int(np.diff(edges).max())
    return ent, stuck


@dataclass
class ChannelHealthMonitor:
    """Hysteresis quarantine of failing electrodes from LBP code blocks.

    Feed each service interval's (T, C) codes to ``observe``; a channel
    whose block statistics look dead/railed (entropy below
    ``min_entropy`` OR a same-code run longer than ``max_stuck``) earns an
    unhealthy strike, and ``quarantine_after`` CONSECUTIVE strikes
    quarantine it (mask 0).  A quarantined channel that produces
    ``reinstate_after`` consecutive healthy blocks is reinstated — the
    hysteresis (quarantine fast, reinstate slowly, never on a single
    block) keeps a flickering electrode from thrashing the mask.  Every
    transition lands in ``events`` (block index, channel, event, the
    triggering statistics).

    ``mask`` is the current (C,) uint8 live mask, shaped for
    ``StreamingFleet.set_channel_mask``.
    """

    channels: int
    n_codes: int = 64
    min_entropy: float = 0.5
    max_stuck: int = 96
    quarantine_after: int = 2
    reinstate_after: int = 4
    mask: np.ndarray = field(init=False)
    events: list[dict] = field(init=False, default_factory=list)

    def __post_init__(self):
        self.mask = np.ones(self.channels, np.uint8)
        self._bad_streak = np.zeros(self.channels, np.int64)
        self._good_streak = np.zeros(self.channels, np.int64)
        self._block = 0

    def observe(self, codes: np.ndarray) -> np.ndarray:
        """Update health state from one (T, C) code block; returns the
        (C,) live mask AFTER this block."""
        codes = np.asarray(codes)
        if codes.ndim != 2 or codes.shape[1] != self.channels:
            raise ValueError(
                f"observe needs a (t, {self.channels}) code block, got "
                f"{codes.shape}")
        if codes.shape[0] == 0:
            return self.mask.copy()
        ent, stuck = channel_stats(codes, n_codes=self.n_codes)
        bad = (ent < self.min_entropy) | (stuck > self.max_stuck)
        self._bad_streak = np.where(bad, self._bad_streak + 1, 0)
        self._good_streak = np.where(bad, 0, self._good_streak + 1)
        for ch in range(self.channels):
            if self.mask[ch] and self._bad_streak[ch] >= \
                    self.quarantine_after:
                self.mask[ch] = 0
                self.events.append({
                    "block": self._block, "channel": ch,
                    "event": "quarantine", "entropy": float(ent[ch]),
                    "stuck_run": int(stuck[ch])})
            elif not self.mask[ch] and self._good_streak[ch] >= \
                    self.reinstate_after:
                self.mask[ch] = 1
                self.events.append({
                    "block": self._block, "channel": ch,
                    "event": "reinstate", "entropy": float(ent[ch]),
                    "stuck_run": int(stuck[ch])})
        self._block += 1
        return self.mask.copy()

    @property
    def n_quarantined(self) -> int:
        return int((self.mask == 0).sum())


class FleetChannelMonitor:
    """One ``ChannelHealthMonitor`` per fleet session.

    ``observe(batch)`` consumes the same (S, T, C) code batch the fleet's
    ``push_codes`` takes and returns the stacked (S, C) live mask —
    changed masks go straight to ``StreamingFleet.set_channel_mask`` (the
    mask operand of the fleet kernel).  ``events`` merges the
    per-session logs with a ``session`` key."""

    def __init__(self, n_sessions: int, channels: int, **monitor_kw):
        self._monitors = [ChannelHealthMonitor(channels, **monitor_kw)
                          for _ in range(n_sessions)]

    def observe(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch)
        if batch.ndim != 3 or batch.shape[0] != len(self._monitors):
            raise ValueError(
                f"observe needs a ({len(self._monitors)}, t, channels) "
                f"batch, got {batch.shape}")
        return np.stack([m.observe(batch[i])
                         for i, m in enumerate(self._monitors)])

    @property
    def masks(self) -> np.ndarray:
        return np.stack([m.mask for m in self._monitors])

    @property
    def events(self) -> list[dict]:
        out = []
        for i, m in enumerate(self._monitors):
            out.extend({**e, "session": i} for e in m.events)
        out.sort(key=lambda e: (e["block"], e["session"], e["channel"]))
        return out

    @property
    def n_quarantined(self) -> int:
        return sum(m.n_quarantined for m in self._monitors)
