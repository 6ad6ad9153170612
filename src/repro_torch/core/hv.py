"""Hypervector primitives on packed words (port of ``repro.core.hv``).

A packed HV is a ``(..., D // 32)`` tensor of ``torch.int32`` words whose
bit pattern equals the reference's ``uint32`` words (LSB-first within a
word: bit ``d`` of the HV is bit ``d % 32`` of word ``d // 32``).  PyTorch
has no shifts or ``index_select`` for ``uint32`` on the CPU, so:

* right shifts are logical by masking: ``(x >> k) & ((1 << (32 - k)) - 1)``
  (``>>`` on int32 is arithmetic);
* left shifts and products wrap modulo 2**32 like the unsigned words;
* popcount is a SWAR helper (``lax_popcount``);
* numpy crosses with ``.view(np.uint32)`` / ``.view(np.int32)``.

Position-domain HVs are ``(..., S)`` uint8 segment positions, as in the
reference.  All functions are batch-leading and device-agnostic.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def n_words(dim: int) -> int:
    if dim % WORD:
        raise ValueError(f"D={dim} must be a multiple of {WORD}")
    return dim // WORD


def to_i32(words: np.ndarray) -> np.ndarray:
    """numpy uint32 words -> the int32 carrier with the same bits."""
    # repro-lint: disable=RPR002  -- numpy in and out: its captured caller reads a host constant
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def to_u32(words: torch.Tensor) -> np.ndarray:
    """int32 carrier tensor -> numpy uint32 words with the same bits."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def _bit_table(device) -> torch.Tensor:
    """(32,) int32 with entry r = the word with only bit r set."""
    return torch.tensor([1 << r for r in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# packing / unpacking
# ---------------------------------------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., D) tensor of {0,1} into (..., D // 32) int32, LSB-first."""
    d = bits.shape[-1]
    w = n_words(d)
    b = bits.reshape(*bits.shape[:-1], w, WORD).to(torch.int32)
    shifts = torch.arange(WORD, dtype=torch.int32, device=bits.device)
    # distinct bits: the wrapping int32 sum is the bitwise OR
    return (b << shifts).sum(-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """Unpack (..., W) int32 words into (..., W * 32) {0,1} uint8."""
    w = words.shape[-1]
    dim = dim if dim is not None else w * WORD
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], w * WORD)[..., :dim].to(torch.uint8)


def lax_popcount(words: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32-carried words (SWAR) -> int32."""
    x = words.to(torch.int32)
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) >> 24) & 0xFF


def popcount(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Total number of set bits along ``axis`` -> int32."""
    return lax_popcount(words).sum(axis, dtype=torch.int32)


def take_along_axis32(a: torch.Tensor, idx: torch.Tensor,
                      axis: int = -1) -> torch.Tensor:
    """``take_along_axis`` with numpy broadcasting of the non-axis dims."""
    axis = axis % a.ndim
    shape = list(torch.broadcast_shapes(
        a.shape[:axis] + (1,) + a.shape[axis + 1:],
        idx.shape[:axis] + (1,) + idx.shape[axis + 1:]))
    a_shape, i_shape = list(shape), list(shape)
    a_shape[axis], i_shape[axis] = a.shape[axis], idx.shape[axis]
    return torch.gather(a.expand(a_shape), axis,
                        idx.to(torch.int64).expand(i_shape))


# ---------------------------------------------------------------------------
# position <-> bit domain
# ---------------------------------------------------------------------------

def positions_to_bits(pos: torch.Tensor, dim: int, segments: int) -> torch.Tensor:
    """(..., S) positions -> (..., D) one-hot-per-segment bits (uint8)."""
    seg_len = dim // segments
    iota = torch.arange(seg_len, device=pos.device)
    onehot = (pos.to(torch.int64).unsqueeze(-1) == iota).to(torch.uint8)
    return onehot.reshape(*pos.shape[:-1], dim)


def positions_to_packed(pos: torch.Tensor, dim: int,
                        segments: int) -> torch.Tensor:
    """(..., S) positions -> (..., D // 32) packed int32 (scatter-free)."""
    seg_len = dim // segments
    if seg_len % WORD:
        return pack_bits(positions_to_bits(pos, dim, segments))
    words_per_seg = seg_len // WORD
    p = pos.to(torch.int64)
    word_idx = p // WORD
    bit = _bit_table(pos.device)[p % WORD]
    iota = torch.arange(words_per_seg, device=pos.device)
    seg_words = torch.where(word_idx.unsqueeze(-1) == iota,
                            bit.unsqueeze(-1), torch.zeros_like(bit).unsqueeze(-1))
    return seg_words.reshape(*pos.shape[:-1], segments * words_per_seg)


def packed_to_positions(words: torch.Tensor, dim: int,
                        segments: int) -> torch.Tensor:
    """Inverse of ``positions_to_packed`` for HVs with exactly one bit per
    segment: the one-hot -> binary decoder of the naive binding.  Returns
    (..., S) uint8 positions."""
    bits = unpack_bits(words, dim)
    seg_len = dim // segments
    seg = bits.reshape(*bits.shape[:-1], segments, seg_len)
    iota = torch.arange(seg_len, dtype=torch.int32, device=words.device)
    return (seg.to(torch.int32) * iota).sum(-1, dtype=torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# random HV generation (design-time codebooks)
# ---------------------------------------------------------------------------

def random_dense_packed(generator: torch.Generator, shape: tuple[int, ...],
                        dim: int) -> torch.Tensor:
    """Random dense (p = 0.5) packed HVs: (*shape, D // 32) int32, drawn on
    the generator's device.  ``jax.random``'s stream cannot be replayed:
    parity with the reference transfers codebooks instead of redrawing."""
    bits = torch.randint(0, 2, (*shape, dim), generator=generator,
                         device=generator.device, dtype=torch.uint8)
    return pack_bits(bits)


# ---------------------------------------------------------------------------
# elementwise packed ops
# ---------------------------------------------------------------------------

def word_parity(words: torch.Tensor) -> torch.Tensor:
    """Per-word parity (popcount mod 2) of int32-carried words -> int32 0/1;
    the ECC codecs' primitive (``reliability/ecc.py``)."""
    return lax_popcount(words) & 1


# uniforms drawn at once by ``random_flip_mask`` (64 MB of float32): a mask
# of any size is drawn in pieces of at most this many bits
_FLIP_CHUNK = 1 << 24


def random_flip_mask(generator: torch.Generator, shape: tuple[int, ...], p,
                     bits: int = WORD) -> torch.Tensor:
    """Bernoulli(p) bit-flip masks: (*shape,) int32 words whose low ``bits``
    bits are each set independently with probability ``p`` (high bits
    zero), drawn on the generator's device.  ``p == 0`` gives all zeros and
    ``p == 1`` every low bit.  ``jax.random``'s stream cannot be replayed:
    parity with the reference hands both packages the same masks."""
    if not 1 <= bits <= WORD:
        raise ValueError(f"bits={bits} must be in [1, {WORD}]")
    dev = generator.device
    n = int(np.prod(shape, dtype=np.int64))
    shifts = torch.arange(bits, dtype=torch.int32, device=dev)
    rows = max(1, _FLIP_CHUNK // bits)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    for i in range(0, n, rows):
        m = min(rows, n - i)
        flips = torch.rand((m, bits), generator=generator, device=dev) < p
        # distinct bits: the int32 sum is their OR and never overflows, bit
        # 31 included (it adds -2**31 to a sum below 2**31)
        out[i:i + m] = (flips.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
    return out.reshape(shape)


def or_reduce(words: torch.Tensor, axis: int) -> torch.Tensor:
    """OR over ``axis`` as a pairwise tree (OR is associative: exact)."""
    axis = axis % words.ndim
    n = words.shape[axis]
    if n == 0:
        raise ValueError("cannot OR-reduce an empty axis")
    while n > 1:
        half = n // 2
        merged = (words.narrow(axis, 0, half)
                  | words.narrow(axis, half, half))
        if n % 2:
            merged = torch.cat([merged, words.narrow(axis, 2 * half, 1)], axis)
        words = merged
        n = words.shape[axis]
    return words.squeeze(axis)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed HVs (last axis = words)."""
    return popcount(a ^ b)


def overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AND+popcount similarity (last axis = words)."""
    return popcount(a & b)


# ---------------------------------------------------------------------------
# bit-plane (time-packed) representation
# ---------------------------------------------------------------------------

def bit_transpose32(x: torch.Tensor) -> torch.Tensor:
    """32x32 bit transpose along axis -2: out[..., b, :] bit j =
    x[..., j, :] bit b (LSB-first).  SWAR butterfly, an involution."""
    if x.shape[-2] != 32:
        raise ValueError(f"axis -2 must have size 32, got {tuple(x.shape)}")
    j, m = 16, 0x0000FFFF
    while j:
        sh = x.shape
        a = x.reshape(*sh[:-2], 32 // (2 * j), 2, j, sh[-1])
        lo, hi = a[..., 0, :, :], a[..., 1, :, :]
        # m's top j bits are clear, so the arithmetic shift is logical here
        t = ((lo >> j) ^ hi) & m
        lo = lo ^ (t << j)
        hi = hi ^ t
        x = torch.stack([lo, hi], dim=-3).reshape(sh)
        j //= 2
        if j:
            m = m ^ ((m << j) & 0xFFFFFFFF)
    return x


def time_pack(words: torch.Tensor) -> torch.Tensor:
    """(..., T, W) cycle-major words -> (..., T // 32, 32, W) bit planes:
    out[..., g, b, w] bit j = bit b of word w at cycle 32 g + j."""
    t = words.shape[-2]
    if t % 32:
        raise ValueError(f"T={t} must be a multiple of 32 (pad the stream)")
    sh = words.shape
    return bit_transpose32(words.reshape(*sh[:-2], t // 32, 32, sh[-1]))


def bitplane_counts(words: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., N, W) packed -> (..., D) int32 bit-position counts over N
    (N % 32 == 0): time-pack, popcount each plane, sum the groups."""
    tp = time_pack(words)                                  # (..., G, 32, W)
    tot = lax_popcount(tp).sum(-3, dtype=torch.int32)      # (..., 32, W)
    return tot.transpose(-1, -2).reshape(*tot.shape[:-2], dim)


def unpacked_counts(words: torch.Tensor, axis: int, dim: int) -> torch.Tensor:
    """Sum of unpacked bits over ``axis`` -> (..., D) int32.  N a multiple
    of 32 takes the bit-plane adder; ragged N adds one unpacked slice at a
    time (peak temporary: one slice)."""
    axis = axis % words.ndim
    n = words.shape[axis]
    if n and n % 32 == 0:
        return bitplane_counts(torch.movedim(words, axis, -2), dim)
    moved = torch.movedim(words, axis, 0)
    acc = torch.zeros((*moved.shape[1:-1], dim), dtype=torch.int32,
                      device=words.device)
    for i in range(n):
        acc += unpack_bits(moved[i], dim).to(torch.int32)
    return acc


def threshold_pack(counts: torch.Tensor, thr) -> torch.Tensor:
    """Thinning: counts (..., D) -> packed (..., D // 32) of [counts >= thr]."""
    return pack_bits((counts >= thr).to(torch.uint8))


def majority_pack(counts: torch.Tensor, n, dim: int) -> torch.Tensor:
    """Majority rule: bit = [count > n / 2] (ties broken low)."""
    del dim
    return pack_bits((counts * 2 > n).to(torch.uint8))
