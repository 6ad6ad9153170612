"""Plain PyTorch versions for the fleet's packed-domain temporal bundling
(port of ``repro.kernels.hdc_fleet.ref``).

* ``fleet_counts_ref`` — per-slot counts from per-cycle spatial HVs by
  popcount prefix sums at the slot boundaries (no masks needed);
* ``emission_masks`` — the time-packed per-slot cycle masks the fused
  kernel consumes;
* ``spatial_bundle`` / ``fleet_counts_plain`` — the plain version of the
  fused fleet kernel itself, on the kernel's own operands.
"""

from __future__ import annotations

import torch

from repro_torch.core import hv


def fleet_counts_ref(words: torch.Tensor, filled: torch.Tensor,
                     lengths: torch.Tensor, *, window: int,
                     dim: int) -> torch.Tensor:
    """words (S, T, W) per-cycle spatial HVs (cycles >= lengths[s] never
    count), filled (S,) cycles already accumulated toward each next frame,
    lengths (S,) valid cycles -> (S, K + 1, D) int32 with
    K = (T - 1) // window + 1: rows 0..K-1 close each completed frame slot,
    row K is the leftover tail."""
    s, t, w = words.shape
    k_max = (t - 1) // window + 1
    t32 = -(-t // 32) * 32
    if t32 != t:
        words = torch.cat([words, words.new_zeros((s, t32 - t, w))], 1)
    groups = t32 // 32
    tb = hv.time_pack(words)                               # (S, G, 32, W)
    gpop = hv.lax_popcount(tb)
    csum = torch.cumsum(gpop, dim=1, dtype=torch.int32)    # (S, G, 32, W)

    filled = filled.to(torch.int32)
    lengths = lengths.to(torch.int32)
    n_emit = torch.div(filled + lengths, window, rounding_mode="floor")
    k = torch.arange(k_max + 2, dtype=torch.int32, device=words.device)
    bx = torch.minimum(k[None, :], n_emit[:, None]) * window - filled[:, None]
    bx = torch.minimum(torch.clamp(bx, min=0), lengths[:, None])  # (S, K+2)
    bx[:, -1] = lengths                                    # tail ends at len
    xg = torch.div(bx, 32, rounding_mode="floor")
    xr = bx - xg * 32
    idx = torch.clamp(xg, max=groups - 1)[..., None, None]
    part = hv.take_along_axis32(tb, idx, axis=1)           # (S, K+2, 32, W)
    # (1 << r) - 1 keeps bits 0..r-1: the first r cycles of the edge group
    edge = (torch.bitwise_left_shift(torch.ones_like(xr), xr) - 1)[..., None, None]
    pref = torch.where((xg > 0)[..., None, None],
                       hv.take_along_axis32(
                           csum, torch.clamp(xg - 1, min=0)[..., None, None],
                           axis=1),
                       0)
    cx = pref + hv.lax_popcount(part & edge)
    seg = cx[:, 1:] - cx[:, :-1]                           # (S, K+1, 32, W)
    return seg.transpose(2, 3).reshape(s, k_max + 1, dim)


def emission_masks(filled: torch.Tensor, lengths: torch.Tensor, *,
                   t_pad: int, window: int) -> torch.Tensor:
    """(S, K + 1, ceil(t_pad / 32)) int32 words: bit j of word g in row k is
    set iff cycle 32 g + j of this step belongs to frame slot k (row K: the
    leftover tail)."""
    t32 = -(-t_pad // 32) * 32
    k_max = (t_pad - 1) // window + 1
    dev = filled.device
    filled = filled.to(torch.int32)
    lengths = lengths.to(torch.int32)
    j = torch.arange(t32, dtype=torch.int32, device=dev)
    ordinal = torch.div(filled[:, None] + j[None, :], window,
                        rounding_mode="floor")             # (S, t32)
    valid = j[None, :] < lengths[:, None]
    n_emit = torch.div(filled + lengths, window, rounding_mode="floor")
    rows = torch.arange(k_max, dtype=torch.int32, device=dev)
    frame = ((ordinal[:, None, :] == rows[None, :, None])
             & (rows[None, :, None] < n_emit[:, None, None])
             & valid[:, None, :])
    tail = (ordinal >= n_emit[:, None]) & valid
    dense = torch.cat([frame, tail[:, None, :]], dim=1)
    return hv.pack_bits(dense.to(torch.uint8))


def spatial_bundle(bound: torch.Tensor, *, mode: str, channels: int,
                   dim: int, threshold: int, live=None) -> torch.Tensor:
    """(..., C, W) bound rows -> (..., W) per-cycle spatial HVs: ``or`` =
    OR tree, ``thin`` = per-bit channel count >= threshold, ``majority`` =
    2 * count > channels.  ``live`` (broadcastable to the leading dims) is
    the masked path's live-channel count: the thinning threshold
    renormalises by ceil(threshold * live / channels) (floored at 1) and
    the majority denominator becomes ``live``."""
    if mode == "or":
        return hv.or_reduce(bound, axis=-2)
    c = bound.shape[-2]
    c32 = -(-c // 32) * 32
    if c32 != c:  # zero rows count nothing; keeps the bit-plane adder
        pad = bound.new_zeros((*bound.shape[:-2], c32 - c, bound.shape[-1]))
        bound = torch.cat([bound, pad], dim=-2)
    counts = hv.unpacked_counts(bound, axis=-2, dim=dim)   # (..., D)
    if mode == "thin":
        if live is None:
            return hv.threshold_pack(counts, threshold)
        thr = torch.clamp(torch.div(threshold * live + channels - 1, channels,
                                    rounding_mode="floor"), min=1)
        return hv.threshold_pack(counts, thr[..., None])
    if mode == "majority":
        n = channels if live is None else live[..., None]
        return hv.majority_pack(counts, n, dim)
    raise ValueError(f"unknown spatial mode {mode!r}")


def fleet_counts_plain(tables: torch.Tensor, owner: torch.Tensor,
                       codes: torch.Tensor, tm: torch.Tensor, *, mode: str,
                       dim: int, threshold: int = 1,
                       chan_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the fused fleet kernel on its own operands:
    tables (P, C, K, W), owner (S,), codes (S, T32, C) uint8, tm
    (S, K1, T32 // 32), optional chan_mask (S, C) -> (S, K1, D) int32."""
    s, t32, c = codes.shape
    p, _, k, w = tables.shape
    o = torch.clamp(owner.to(torch.int64), 0, p - 1)
    cb = torch.clamp(codes.to(torch.int64), max=k - 1)     # in-channel clamp
    ch = torch.arange(c, device=codes.device)
    bound = tables[o[:, None, None], ch, cb]                # (S, T32, C, W)
    live = None
    if chan_mask is not None:
        cm = chan_mask.to(torch.int32)
        bound = bound * cm[:, None, :, None]   # wraps like the uint32 product
        live = cm.sum(1, dtype=torch.int32)[:, None]        # (S, 1)
    words = spatial_bundle(bound, mode=mode, channels=c, dim=dim,
                           threshold=threshold, live=live)  # (S, T32, W)
    planes = hv.time_pack(words)                            # (S, G, 32, W)
    masks = tm.transpose(1, 2)[..., None, None]             # (S, G, K1, 1, 1)
    contrib = hv.lax_popcount(planes[:, :, None] & masks)   # (S, G, K1, 32, W)
    counts = contrib.sum(1, dtype=torch.int32)              # (S, K1, 32, W)
    return counts.transpose(2, 3).reshape(s, tm.shape[1], dim)
