"""Synthetic iEEG made on the device from a seed.

A torch rewrite of the port's ``data/ieeg.py`` generator (an AR(2)
background with rhythmic ictal discharges, channel recruitment and a 2 s
ramp), made for long recordings:

* the AR(2) recursion ``x[t] = 0.9 x[t-1] - 0.25 x[t-2] + e[t]`` has poles
  of modulus 0.5, so its impulse response falls below float32's resolution
  within 48 taps; the background is that 48-tap filter applied to the noise
  by 48 fused multiply-adds, which is the recursion to float32 rounding and
  runs on the card in milliseconds an hour;
* the discharge's phase is the closed-form integral of its drifting
  frequency instead of a cumulative sum.

Recordings are (T, channels) float32, the layout the LBP kernel reads.
Labels are per sample, aligned with the LBP codes as the port's generator
aligns them (code ``t`` carries sample ``t``'s label); a frame is ictal when
at least half of its samples are.

Random draws: the noise on the device from a ``torch.Generator`` there; the
few scalars of a patient or a seizure from numpy.  Every draw is keyed by
``sub_seed``, so the same seed gives the same recordings.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

FS = 512
TAPS = 48
A1, A2 = 0.9, -0.25


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one draw, from the run's seed (any size) and keys."""
    h = hashlib.blake2b(repr((int(seed),) + keys).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, device, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *keys))
    return g


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


def _impulse() -> list[float]:
    h = [1.0, A1]
    for _ in range(2, TAPS):
        h.append(A1 * h[-1] + A2 * h[-2])
    return h


IMPULSE = _impulse()


def patient(seed: int, pid: int, channels: int) -> dict:
    """A patient's seizure fingerprint: base frequency, recruited channels."""
    r = rng(seed, "patient", pid)
    base = float(r.uniform(18.0, 40.0))
    frac = float(r.uniform(0.4, 0.8))
    part = (r.random(channels) < frac).astype(np.float32)
    if part.sum() == 0:
        part[r.integers(channels)] = 1.0
    return {"base_freq": base, "participation": part}


def background(g: torch.Generator, t: int, channels: int, device) -> torch.Tensor:
    """(t, channels) float32 AR(2) background."""
    e = torch.randn((t + TAPS - 1, channels), generator=g, device=device)
    x = e[TAPS - 1:] * IMPULSE[0]
    for k in range(1, TAPS):
        x.add_(e[TAPS - 1 - k: TAPS - 1 - k + t], alpha=IMPULSE[k])
    return x


def add_seizure(x: torch.Tensor, g: torch.Generator, r: np.random.Generator,
                pat: dict, onset: int, length: int, fs: int = FS) -> None:
    """Add one ictal discharge over samples [onset, onset + length)."""
    channels = x.shape[1]
    dev = x.device
    f0 = pat["base_freq"] * float(r.uniform(0.9, 1.1))
    gains = (pat["participation"] * r.uniform(6.0, 12.0, channels)).astype(np.float32)
    tt = torch.arange(length, device=dev, dtype=torch.float64) / fs
    w = 2 * math.pi * 0.05
    phase = 2 * math.pi * f0 * (tt + 0.15 * (1.0 - torch.cos(w * tt)) / w)
    wave = torch.sin(phase) * (1.0 + 0.3 * torch.sin(2 * math.pi * 2.7 * tt))
    ramp = torch.clamp(tt / 2.0, max=1.0)
    jitter = torch.randn((length, channels), generator=g, device=dev) * 0.2
    gain = torch.as_tensor(gains, device=dev)
    x[onset:onset + length] += (wave.to(torch.float32)[:, None] + jitter) * gain \
        * ramp.to(torch.float32)[:, None]


def recording(seed: int, key: tuple, pat: dict, t: int, channels: int,
              seizures: list[tuple[int, int]], device) -> torch.Tensor:
    """One (t, channels) float32 recording with the given (onset, length)
    seizures, on ``device``."""
    g = generator(seed, device, "rec", *key)
    r = rng(seed, "rec", *key)
    x = background(g, t, channels, device)
    for onset, length in seizures:
        add_seizure(x, g, r, pat, onset, length)
    return x


def place_seizures(seed: int, key: tuple, t: int, n: int, length_s: tuple[float, float],
                   fs: int = FS) -> list[tuple[int, int]]:
    """``n`` non-overlapping seizures in a recording of ``t`` samples: slot
    ``i`` of ``n`` equal slots holds seizure ``i`` at a random offset."""
    r = rng(seed, "onsets", *key)
    out = []
    slot = t // max(n, 1)
    for i in range(n):
        length = min(int(r.uniform(*length_s) * fs), slot - 1)
        onset = i * slot + int(r.integers(0, slot - length))
        out.append((onset, length))
    return out


def frame_labels(seizures: list[tuple[int, int]], n_codes: int, window: int) -> np.ndarray:
    """(n_codes // window,) int32: 1 where at least half of a frame's
    samples lie inside a seizure."""
    lab = np.zeros(n_codes, dtype=np.int32)
    for onset, length in seizures:
        lab[onset:onset + length] = 1
    f = n_codes // window
    return (lab[:f * window].reshape(f, window).sum(1) * 2 >= window).astype(np.int32)
