"""ECC word codecs for packed-domain associative memories (port of
``repro.reliability.ecc``).

The AM stores one packed 32-bit word per 32 HV bits, and each word is
protected on its own by one of three schemes:

* ``none``   — raw storage, no check bits (the paper's design);
* ``parity`` — one even-parity bit per word: detects any odd number of
  flips, corrects nothing;
* ``secded`` — Hamming SECDED(39, 32): 6 Hamming check bits plus one
  overall parity bit.  Any single flip of the 39-bit codeword is corrected,
  any double flip is detected as uncorrectable (triple flips may
  miscorrect, as in real SECDED SRAM).

Words ride the port's int32 carrier (``core/hv.py``); check words hold the
check bits in their low 7 bits.  ``decode`` classifies each word as clean
(0), corrected (1) or uncorrectable (2), which the fleet sums into its
per-session [corrected, detected, uncorrectable] counters.  All codecs are
elementwise tensor code over any leading axes, on any device.

The cost side counts the XOR/AND gate evaluations of one word's read-path
decode and prices a whole AM read through ``core/hwmodel.py``'s 16nm gate
constants, so raw and protected AMs land on one energy axis.

Codeword layout (SECDED): Hamming positions 1..38 hold the 6 check bits at
the powers of two and the 32 data bits at the rest; a flipped data bit at
position p gives syndrome p, a flipped check bit i gives syndrome 2**i.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import hv, hwmodel

SCHEMES = ("none", "parity", "secded")

# word-level decode status codes
CLEAN, CORRECTED, UNCORRECTABLE = 0, 1, 2


def _secded_tables() -> tuple[np.ndarray, np.ndarray]:
    """(parity_masks (6,) uint32, synd_flip (64,) uint32) for SECDED(39,32):
    ``parity_masks[i]`` selects the data bits that Hamming check bit ``i``
    covers (data bit j sits at the j-th codeword position that is no power
    of two); ``synd_flip[s]`` is the data-word XOR that corrects syndrome
    ``s`` (0 where ``s`` names a check bit, the overall bit or nothing)."""
    data_pos = [p for p in range(1, 39) if p & (p - 1)]  # 32 of them
    assert len(data_pos) == hv.WORD
    masks = np.zeros(6, np.uint32)
    flip = np.zeros(64, np.uint32)
    for j, p in enumerate(data_pos):
        flip[p] = np.uint32(1) << j
        for i in range(6):
            if (p >> i) & 1:
                masks[i] |= np.uint32(1) << j
    return masks, flip


_PARITY_MASKS, _SYND_FLIP = _secded_tables()
# the masks as int32 carrier values (bit 31 set -> negative), for ``&``
_PARITY_MASKS_I32 = [int(m) for m in hv.to_i32(_PARITY_MASKS)]

_CHECK_BITS = {"none": 0, "parity": 1, "secded": 7}


@functools.lru_cache(maxsize=None)
def _synd_flip(device: torch.device) -> torch.Tensor:
    """``_SYND_FLIP`` as an int32 carrier on ``device`` (its entry for data
    bit 31 is negative), made once per device: a constant, so a decode on
    the card copies nothing from the host."""
    return torch.from_numpy(hv.to_i32(_SYND_FLIP).copy()).to(device)


def n_check_bits(scheme: str) -> int:
    """Stored check bits per protected 32-bit word."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown ECC scheme {scheme!r}; pick from {SCHEMES}")
    return _CHECK_BITS[scheme]


def encode(words: torch.Tensor, scheme: str = "secded") -> torch.Tensor:
    """Check words for int32-carried ``words`` (same shape, low bits): what
    the AM's write path stores beside each data word.  The fleet recomputes
    them from the clean rows every step, which equals carrying stored check
    bits, since the fault model corrupts reads, never storage."""
    n_check_bits(scheme)  # validate
    if scheme == "none":
        return torch.zeros_like(words)
    if scheme == "parity":
        return hv.word_parity(words)
    check = torch.zeros_like(words)
    for i, m in enumerate(_PARITY_MASKS_I32):
        check = check | (hv.word_parity(words & m) << i)
    overall = hv.word_parity(words) ^ hv.word_parity(check)
    return check | (overall << 6)


def decode(words: torch.Tensor, check: torch.Tensor, scheme: str = "secded"
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode possibly corrupted (word, check) pairs.  Returns
    ``(corrected_words, status)``, status int32 per word: ``CLEAN``,
    ``CORRECTED`` (data repaired, or the flip was in a check bit and the
    data was clean) or ``UNCORRECTABLE`` (SECDED double flips; any parity
    mismatch, which corrects nothing)."""
    n_check_bits(scheme)  # validate
    if scheme == "none":
        return words, torch.zeros(words.shape, dtype=torch.int32, device=words.device)
    if scheme == "parity":
        mismatch = hv.word_parity(words) ^ (check & 1)
        return words, mismatch * UNCORRECTABLE
    syn = torch.zeros_like(words)
    for i, m in enumerate(_PARITY_MASKS_I32):
        rx = (check >> i) & 1      # check bits sit below bit 7: no sign
        syn = syn | ((hv.word_parity(words & m) ^ rx) << i)
    # parity over all 39 received bits: odd -> an odd number of flips
    overall = hv.word_parity(words) ^ hv.word_parity(check & 0x7F)
    single = overall == 1
    flip = _synd_flip(words.device)[syn.to(torch.int64)]
    corrected = torch.where(single, words ^ flip, words)
    status = torch.where(single, CORRECTED,
                         torch.where(syn != 0, UNCORRECTABLE, CLEAN))
    return corrected, status.to(torch.int32)


# ---------------------------------------------------------------------------
# cost model: gate ops per read -> energy through core/hwmodel.py constants
# ---------------------------------------------------------------------------

def ops_per_word(scheme: str) -> dict[str, int]:
    """Gate evaluations of one word's read-path decode, by gate kind.

    ``parity``: one 33-input XOR tree (data and stored parity bit).
    ``secded``: six syndrome trees over the covered data bits, six check-bit
    compares, the 39-input overall-parity tree, the 6 -> 38 syndrome decode
    (two AND2 levels a line), the 32 correction XORs and their single-error
    gating ANDs.  Keys are ``hwmodel.gate_energy_fj``'s gate kinds."""
    n_check_bits(scheme)  # validate
    if scheme == "none":
        return {"xor2": 0, "and2": 0}
    if scheme == "parity":
        return {"xor2": 32, "and2": 0}
    tree_xor = int(sum(int(m).bit_count() - 1 for m in _PARITY_MASKS))
    return {
        "xor2": tree_xor + 6 + 38 + 32,  # trees + compare + overall + fix
        "and2": 2 * 38 + 32,             # syndrome decode + correction gate
    }


def read_ops(scheme: str, n_classes: int, words: int) -> dict[str, int]:
    """Gate evaluations of one full AM read (every class row decoded)."""
    per = ops_per_word(scheme)
    n = n_classes * words
    return {k: v * n for k, v in per.items()}


def raw_am_read_ops(n_classes: int, words: int) -> dict[str, int]:
    """Ops of the unprotected AM similarity read, the overhead's base: per
    word one 32-bit AND, and the popcount's adder tree (D - 1 full adders
    a row)."""
    return {"and2": n_classes * words * hv.WORD,
            "fa": n_classes * (words * hv.WORD - 1)}


def read_energy_nj(scheme: str, n_classes: int, words: int,
                   c: hwmodel.HWConstants = hwmodel.C16) -> float:
    """Energy (nJ) of one AM read's ECC decode."""
    return hwmodel.gate_energy_fj(read_ops(scheme, n_classes, words), c) * 1e-6


def read_overhead(scheme: str, n_classes: int, words: int,
                  c: hwmodel.HWConstants = hwmodel.C16) -> float:
    """ECC decode energy as a fraction of the raw AM similarity read."""
    base = hwmodel.gate_energy_fj(raw_am_read_ops(n_classes, words), c)
    return hwmodel.gate_energy_fj(read_ops(scheme, n_classes, words), c) / base
