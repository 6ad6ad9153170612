"""Synthetic iEEG data + local-binary-pattern (LBP) preprocessing.

A numpy copy of ``repro.data.ieeg`` (the port imports nothing of the
reference package): the same seeds give the same records bit for bit.
``make_patient`` also forwards ``signal_transform`` to every record, which
lets a caller keep each record's raw signal (an identity transform that
stores a reference) to run the LBP stage on the card.

The SWEC-ETHZ one-shot iEEG dataset of [1] is not redistributable offline, so
we generate synthetic patients whose *LBP-code statistics* differ between
interictal background and ictal discharge the way real iEEG does:

* interictal: smooth AR(2) background (low-frequency dominated) + noise
* ictal: superimposed rhythmic 8–20 Hz discharge with per-channel gain and a
  recruitment profile (a subset of channels participates, as in focal onsets)

LBP (Burrello et al. [1]): the 6-bit code at time t encodes the signs of the
six consecutive first differences x[t-5..t] — exactly what the HDC item
memory consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FS = 512  # Hz, matches the short-term SWEC-ETHZ recordings


# ---------------------------------------------------------------------------
# LBP preprocessing
# ---------------------------------------------------------------------------

def validate_signal(x: np.ndarray, *, adc_limit: float | None = None
                    ) -> np.ndarray:
    """Ingest guard for raw iEEG: reject non-finite samples, clamp rails.

    NaN/Inf samples raise — a NaN propagates through ``np.diff`` into
    ``False`` comparisons and silently corrupts every LBP code in its
    6-sample neighborhood, which is far worse than failing loudly at the
    boundary.  With ``adc_limit`` the signal is clamped to the converter
    rails ``[-adc_limit, +adc_limit]`` (what a real front-end does in
    hardware: out-of-range samples saturate, they don't wrap)."""
    x = np.asarray(x)
    bad = ~np.isfinite(x)
    if bad.any():
        idx = np.argwhere(bad)[0]
        raise ValueError(
            f"signal contains {int(bad.sum())} non-finite sample(s) "
            f"(first at index {tuple(int(i) for i in idx)}); NaN/Inf "
            "silently corrupts LBP codes — sanitize the recording before "
            "ingest")
    if adc_limit is not None:
        if adc_limit <= 0:
            raise ValueError(f"adc_limit={adc_limit!r} must be positive")
        x = np.clip(x, -adc_limit, adc_limit)
    return x


def lbp_codes_np(x: np.ndarray, bits: int = 6,
                 adc_limit: float | None = None) -> np.ndarray:
    """x: (..., T) raw signal -> (..., T - bits) uint8 LBP codes.

    code[t] = sum_i 2^i * [ x[t - i] > x[t - i - 1] ],  i = 0..bits-1

    Rejects NaN/Inf input and (with ``adc_limit``) clamps out-of-range
    samples to the ADC rails first — see ``validate_signal``.
    """
    x = validate_signal(x, adc_limit=adc_limit)
    d = (np.diff(x, axis=-1) > 0).astype(np.uint8)           # (..., T-1)
    t_out = d.shape[-1] - bits + 1
    code = np.zeros((*d.shape[:-1], t_out), dtype=np.uint8)
    for i in range(bits):
        code |= d[..., bits - 1 - i : bits - 1 - i + t_out] << i
    return code


# ---------------------------------------------------------------------------
# synthetic patients
# ---------------------------------------------------------------------------

@dataclass
class SeizureRecord:
    codes: np.ndarray        # (T, channels) uint8 LBP codes
    onset_sample: int        # sample index of expert-marked onset
    label: np.ndarray        # (T,) 0 interictal / 1 ictal per sample


@dataclass
class Patient:
    pid: int
    records: list[SeizureRecord] = field(default_factory=list)
    channels: int = 64


def _ar2_background(rng: np.random.Generator, t: int, channels: int) -> np.ndarray:
    """Broadband AR(2) background, per-channel independent.

    Real interictal iEEG is broadband (first differences alternate sign
    often), so LBP codes spread over the code alphabet; the ictal discharge
    concentrates them.  Mild poles keep some 1/f character without the
    pathological low-pass that would concentrate background codes too.
    """
    a1, a2 = 0.9, -0.25
    e = rng.standard_normal((channels, t + 64)).astype(np.float32)
    x = np.zeros_like(e)
    for i in range(2, t + 64):
        x[:, i] = a1 * x[:, i - 1] + a2 * x[:, i - 2] + e[:, i]
    return x[:, 64:]


def _ictal_discharge(rng: np.random.Generator, t: int, channels: int,
                     fs: int, seed_freq: float, participation: np.ndarray) -> np.ndarray:
    """Rhythmic discharge with slow frequency drift and channel recruitment."""
    tt = np.arange(t) / fs
    freq = seed_freq * (1.0 + 0.15 * np.sin(2 * np.pi * 0.05 * tt))
    phase = 2 * np.pi * np.cumsum(freq) / fs
    # rhythmic discharge whose per-sample derivative dominates the background
    # first differences -> LBP code statistics shift strongly during ictal
    wave = np.sin(phase) * (1.0 + 0.3 * np.sin(2 * np.pi * 2.7 * tt))
    gains = participation[:, None] * rng.uniform(6.0, 12.0, (channels, 1)).astype(np.float32)
    jitter = rng.standard_normal((channels, t)).astype(np.float32) * 0.2
    return gains * (wave[None, :].astype(np.float32) + jitter)


def make_record(rng: np.random.Generator, *, channels: int = 64,
                pre_s: float = 30.0, ictal_s: float = 40.0, post_s: float = 10.0,
                fs: int = FS, seed_freq: float | None = None,
                participation_frac: float = 0.6,
                signal_transform=None) -> SeizureRecord:
    """``signal_transform`` (optional ``f(x, rng) -> x`` over the raw
    (channels, T) float signal, applied just before LBP coding) is the
    electrode-fault injection hook: ``reliability.channels`` builds
    transforms that kill/saturate/noise individual channels, so faulted
    records flow through the exact production preprocessing."""
    if seed_freq is None:
        seed_freq = float(rng.uniform(18.0, 40.0))
    t_pre, t_ict, t_post = int(pre_s * fs), int(ictal_s * fs), int(post_s * fs)
    t = t_pre + t_ict + t_post
    x = _ar2_background(rng, t, channels)
    sf = seed_freq
    part = (rng.random(channels) < participation_frac).astype(np.float32)
    if part.sum() == 0:
        part[rng.integers(channels)] = 1.0
    # ramp the discharge in over 2 s (seizures recruit gradually)
    ramp = np.clip(np.arange(t_ict) / (2.0 * fs), 0.0, 1.0).astype(np.float32)
    x[:, t_pre:t_pre + t_ict] += _ictal_discharge(rng, t_ict, channels, fs, sf, part) * ramp
    if signal_transform is not None:
        x = np.asarray(signal_transform(x, rng), np.float32)
        if x.shape != (channels, t):
            raise ValueError(
                f"signal_transform must preserve the ({channels}, {t}) "
                f"signal shape, got {x.shape}")
    codes = lbp_codes_np(x)                       # (channels, T-6)
    label = np.zeros(t, dtype=np.int32)
    label[t_pre:t_pre + t_ict] = 1
    return SeizureRecord(codes=codes.T.copy(), onset_sample=t_pre, label=label[: codes.shape[-1]])


def make_patient(pid: int, *, n_seizures: int = 4, channels: int = 64,
                 seed: int | None = None, signal_transform=None) -> Patient:
    """Patient = a fixed seizure 'fingerprint' (freq band, focus) + n records.
    ``signal_transform`` is passed to every ``make_record``."""
    rng = np.random.default_rng(seed if seed is not None else 1000 + pid)
    base_freq = float(rng.uniform(18.0, 40.0))
    part_frac = float(rng.uniform(0.4, 0.8))
    recs = [
        make_record(rng, channels=channels,
                    seed_freq=base_freq * float(rng.uniform(0.9, 1.1)),
                    participation_frac=part_frac,
                    signal_transform=signal_transform)
        for _ in range(n_seizures)
    ]
    return Patient(pid=pid, records=recs, channels=channels)


def frame_labels(record: SeizureRecord, window: int) -> np.ndarray:
    """Per-frame labels: frame is ictal if >= half its samples are ictal."""
    f = record.label.shape[0] // window
    lab = record.label[: f * window].reshape(f, window)
    return (lab.mean(axis=1) >= 0.5).astype(np.int32)


def onset_frame(record: SeizureRecord, window: int) -> int:
    return int(np.ceil(record.onset_sample / window))
