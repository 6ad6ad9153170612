"""First-order 16nm energy/area model with simulated switching activity
(port of ``repro.core.hwmodel``).

* **Area**: a gate and storage inventory per module per design variant
  (``area_inventory``), times 16nm FinFET cell-area proxies.
* **Energy**: the functional datapath runs cycle by cycle on an LBP code
  stream; each module's output-signal bit toggles are counted (what a
  switching-annotated power analysis measures) and priced with per-wire
  toggle and per-operation energies (``energy_per_prediction``).

The constants are order-of-magnitude proxies at 0.75 V / 10 MHz: the model
is read by structure (which module dominates) and by ratios between
variants, and ``calibration_factors`` anchors its absolute scale to the
paper's optimised design.  The ratios it gives are the model's outputs,
not measurements of any chip.

Variants: ``dense`` (XOR bind, majority bundling), ``sparse_naive``
(1024-bit IM, decoder, barrel shifter, adder trees with thinning),
``sparse_compim`` (CompIM: 56-bit IM, 7-bit adder binding, 7->128 demux;
adder trees with thinning) and ``sparse_opt`` (CompIM with OR-tree
spatial bundling: the paper's proposal).

The switching simulation is plain tensor code on the device of the params
handed in (the card, or the CPU when the caller builds them there); there
is no kernel in this module, as there is none in the reference.  Toggle
sums are exact integer sums, turned into float32 means as the reference
does.  ``gate_energy_fj`` prices the ECC cost model's gate counts
(``reliability/ecc.py``) with the same constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import binding, bundling, hv, im
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import DenseIMParams

VARIANTS = ("dense", "sparse_naive", "sparse_compim", "sparse_opt")


@dataclass(frozen=True)
class HWConstants:
    # area, um^2 per cell
    a_ff: float = 1.20          # flip-flop
    a_fa: float = 1.00          # full adder
    a_ha: float = 0.55          # half adder
    a_or2: float = 0.25
    a_and2: float = 0.25
    a_xor2: float = 0.50
    a_mux2: float = 0.45        # per mux bit
    a_rom_bit: float = 0.05     # synthesized random-logic LUT bit
    a_cmp_bit: float = 0.50     # comparator per bit
    # energy, fJ
    e_toggle: float = 1.5       # per toggled net (avg gate-input cap)
    e_ff_clk: float = 0.08      # clock load per FF per cycle
    e_ff_toggle: float = 4.0    # per FF data toggle (incl. local clk gating)
    e_rom_bit_read: float = 0.12   # per LUT output bit evaluated
    e_fa_op: float = 3.0        # per active full-add
    e_mux_bit: float = 1.2      # per mux bit whose output toggles
    e_mux_sel: float = 0.25     # per mux bit re-steered by a select toggle
    e_gate_op: float = 0.6      # OR/AND evaluation with toggling input
    e_cmp_bit: float = 1.0


C16 = HWConstants()


def gate_energy_fj(ops: dict[str, float], c: HWConstants = C16) -> float:
    """Energy (fJ) of a bag of gate evaluations, by gate kind (``xor2``,
    ``and2``, ``or2``, ``fa``, ``ff``, ``cmp_bit``).  An XOR2 is priced as
    two gate-equivalents."""
    per_op = {
        "xor2": 2.0 * c.e_gate_op,
        "and2": c.e_gate_op,
        "or2": c.e_gate_op,
        "fa": c.e_fa_op,
        "ff": c.e_ff_toggle,
        "cmp_bit": c.e_cmp_bit,
    }
    unknown = set(ops) - set(per_op)
    if unknown:
        raise ValueError(f"unknown gate kinds {sorted(unknown)}; "
                         f"pick from {sorted(per_op)}")
    return float(sum(n * per_op[k] for k, n in ops.items()))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _mean32(total: torch.Tensor, n: int) -> torch.Tensor:
    """An exact integer sum over ``n`` as the reference's float32 mean."""
    return total.to(torch.float32) / n


def _toggles_packed(sig: torch.Tensor) -> torch.Tensor:
    """sig: (T, ...) packed int32 words -> mean toggled bits per cycle."""
    x = sig[1:] ^ sig[:-1]
    return _mean32(hv.lax_popcount(x).sum(dtype=torch.int64), sig.shape[0] - 1)


def _toggles_uint(sig: torch.Tensor, bits: int) -> torch.Tensor:
    """sig: (T, ...) small non-negative ints -> mean toggled bits per cycle
    of the low ``bits``."""
    a = sig.to(torch.int32)
    x = (a[1:] ^ a[:-1]) & ((1 << bits) - 1)
    return _mean32(hv.lax_popcount(x).sum(dtype=torch.int64), sig.shape[0] - 1)


def _mean_ones(words: torch.Tensor) -> float:
    """Mean set bits a row of (N, W) packed words."""
    return float(_mean32(hv.popcount(words).sum(dtype=torch.int64),
                         words.shape[0]))


# ---------------------------------------------------------------------------
# area inventories (um^2 per module)
# ---------------------------------------------------------------------------

def area_inventory(variant: str, cfg: HDCConfig, c: HWConstants = C16) -> dict[str, float]:
    D, S, C_ch = cfg.dim, cfg.segments, cfg.channels
    L = cfg.seg_len                      # 128
    pos_bits = int(np.ceil(np.log2(L)))  # 7
    codes = cfg.codes                    # 64
    cnt_bits = int(np.ceil(np.log2(C_ch + 1)))   # 7-bit spatial counts
    tmp_bits = int(np.ceil(np.log2(cfg.window + 1)))  # 8-bit temporal counters

    # adder-tree size with bit-width growth: summing N 1-bit leaves costs
    # sum_l (N/2^l)*l full adders ~= 2N FA-equivalents (vs N-1 for 1-bit OR)
    fa_tree = 1.2 * C_ch   # 3:2-compressor trees, synthesis-efficient

    a: dict[str, float] = {}
    if variant == "dense":
        a["im"] = C_ch * codes * D * c.a_rom_bit * 1.2   # dense random contents compress poorly
        a["binding"] = C_ch * D * c.a_xor2
        a["spatial_bundling"] = D * (fa_tree * c.a_fa + cnt_bits * c.a_cmp_bit) + D * c.a_ff
        a["decoder"] = 0.0
    elif variant == "sparse_naive":
        # sparse one-hot contents optimize well -> lower effective bit area
        a["im"] = C_ch * codes * D * c.a_rom_bit * 0.35
        # one-hot -> binary encoder: per segment, pos_bits OR-trees over L/2 inputs
        a["decoder"] = C_ch * S * pos_bits * (L / 2) * c.a_or2
        # barrel shifter with a CONSTANT one-hot input (the electrode HV):
        # synthesis collapses it to offset-add + 7->128 decode per segment
        a["binding"] = C_ch * S * (pos_bits * c.a_ha + 2 * L * c.a_and2)
        a["spatial_bundling"] = D * (fa_tree * c.a_fa + cnt_bits * c.a_cmp_bit) + D * c.a_ff
    else:  # sparse_compim / sparse_opt
        a["im"] = C_ch * codes * S * pos_bits * c.a_rom_bit  # 56-bit entries
        a["decoder"] = 0.0                                    # fused into CompIM
        # 7-bit adder (mod-128 = natural 7-bit wrap) + 7->128 demux per segment
        a["binding"] = C_ch * S * (pos_bits * c.a_fa + L * 2 * c.a_and2)
        if variant == "sparse_compim":
            a["spatial_bundling"] = D * (fa_tree * c.a_fa + cnt_bits * c.a_cmp_bit) + D * c.a_ff
        else:  # sparse_opt: OR trees, no threshold
            a["spatial_bundling"] = D * (C_ch - 1) * c.a_or2 + D * c.a_ff

    # temporal bundling and AM are shared across variants
    a["temporal_bundling"] = D * (tmp_bits * c.a_ff + tmp_bits * c.a_ha
                                  + tmp_bits * c.a_cmp_bit)
    gate = c.a_xor2 if variant == "dense" else c.a_and2
    a["am"] = (cfg.n_classes * D * c.a_ff          # class HV storage
               + D * gate                          # AND / XNOR similarity
               + (D - 1) * c.a_fa                  # popcount tree
               + 16 * c.a_cmp_bit + 64 * c.a_ff)   # score compare + regs
    a["control"] = 0.05 * sum(a.values())
    return a


# ---------------------------------------------------------------------------
# switching-activity simulation -> energy per prediction
# ---------------------------------------------------------------------------

def _temporal(sig: dict, cfg: HDCConfig, dense: bool) -> None:
    """The temporal counters (running within-frame prefix sums of the
    spatial bits) and the frame HVs, added to ``sig``."""
    frames = sig["spat"].shape[0] // cfg.window
    spat_f = sig["spat"][: frames * cfg.window].reshape(frames, cfg.window, -1)
    bits = hv.unpack_bits(spat_f, cfg.dim).to(torch.int32)
    tcnt = torch.cumsum(bits, dim=1, dtype=torch.int32).reshape(
        frames * cfg.window, cfg.dim)
    sig["tcnt"] = tcnt
    last = tcnt[cfg.window - 1 :: cfg.window]
    sig["frame_hv"] = (hv.pack_bits((last * 2 > cfg.window).to(torch.uint8)) if dense
                       else hv.threshold_pack(last, cfg.temporal_threshold))


def _sparse_signals(params: im.IMParams, codes: torch.Tensor, cfg: HDCConfig,
                    variant: str) -> dict[str, torch.Tensor]:
    """Per-cycle signal traces for one stream; codes (T, channels)."""
    sig: dict[str, torch.Tensor] = {}
    if variant == "sparse_naive":
        im_out = im.im_lookup_packed(params, codes)                   # (T, C, W)
        dec = hv.packed_to_positions(im_out, cfg.dim, cfg.segments)   # (T, C, S)
        bound = binding.bind_segmented_packed(im_out, params.elec_packed,
                                              cfg.dim, cfg.segments)  # (T, C, W)
        counts = bundling.spatial_counts_packed(bound, cfg.dim)       # (T, D)
        spat = hv.threshold_pack(counts, cfg.spatial_threshold)       # (T, W)
        sig |= dict(im_out=im_out, dec=dec, bound_pos=None, bound=bound,
                    counts=counts, spat=spat)
    else:
        pos = im.im_lookup_positions(params, codes)                   # (T, C, S)
        bpos = binding.bind_positions(pos, params.elec_pos, cfg.seg_len)
        bound = hv.positions_to_packed(bpos, cfg.dim, cfg.segments)   # demux out
        if variant == "sparse_compim":
            counts = bundling.spatial_counts_positions(bpos, cfg.dim, cfg.segments)
            spat = hv.threshold_pack(counts, cfg.spatial_threshold)
        else:
            counts = None
            spat = hv.or_reduce(bound, axis=-2)
        sig |= dict(im_out=pos, dec=None, bound_pos=bpos, bound=bound,
                    counts=counts, spat=spat)
    _temporal(sig, cfg, dense=False)
    return sig


def _dense_signals(params: DenseIMParams, codes: torch.Tensor,
                   cfg: HDCConfig) -> dict[str, torch.Tensor]:
    ch = torch.arange(cfg.channels, device=codes.device)
    im_out = params.item_packed[ch, codes.to(torch.int64)]           # (T, C, W)
    bound = im_out ^ params.elec_packed
    counts = hv.unpacked_counts(bound, axis=-2, dim=cfg.dim)          # (T, D)
    spat = hv.pack_bits((counts * 2 > cfg.channels).to(torch.uint8))
    sig = dict(im_out=im_out, dec=None, bound_pos=None, bound=bound,
               counts=counts, spat=spat)
    _temporal(sig, cfg, dense=True)
    return sig


def energy_per_prediction(variant: str, params, codes, cfg: HDCConfig,
                          c: HWConstants = C16) -> dict[str, float]:
    """Energy (nJ) per prediction (= one ``window``-cycle frame), by module.
    codes: (T, channels) uint8 with T a multiple of ``cfg.window``; moved to
    the params' device."""
    D, S, C_ch, L = cfg.dim, cfg.segments, cfg.channels, cfg.seg_len
    pos_bits = int(np.ceil(np.log2(L)))
    cnt_bits = int(np.ceil(np.log2(C_ch + 1)))
    tmp_bits = int(np.ceil(np.log2(cfg.window + 1)))
    W = cfg.window
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.asarray(codes))
    codes = codes.to(params.device)

    if variant == "dense":
        sig = _dense_signals(params, codes, cfg)
    else:
        sig = _sparse_signals(params, codes, cfg, variant)

    e: dict[str, float] = {}
    if variant == "dense":
        rom_bits_read = C_ch * D
        im_togg = float(_toggles_packed(sig["im_out"]))
        e["im"] = rom_bits_read * c.e_rom_bit_read + im_togg * c.e_toggle
        e["decoder"] = 0.0
        e["binding"] = float(_toggles_packed(sig["bound"])) * (c.e_gate_op + c.e_toggle)
        cnt_togg = float(_toggles_uint(sig["counts"], cnt_bits))
        e["spatial_bundling"] = (float(_toggles_packed(sig["bound"])) * 1.0 * c.e_fa_op
                                 + cnt_togg * c.e_toggle
                                 + float(_toggles_packed(sig["spat"]))
                                 * (c.e_cmp_bit + c.e_ff_toggle))
    elif variant == "sparse_naive":
        rom_bits_read = C_ch * D
        im_togg = float(_toggles_packed(sig["im_out"]))
        e["im"] = rom_bits_read * c.e_rom_bit_read + im_togg * c.e_toggle
        # encoder: toggled one-hot inputs propagate through log2(L)-deep OR
        # trees; each toggled input disturbs ~pos_bits internal nets
        dec_togg = float(_toggles_uint(sig["dec"], pos_bits))
        e["decoder"] = im_togg * c.e_gate_op * pos_bits + dec_togg * c.e_toggle
        # constant-input barrel shifter == offset-add + 7->128 decode
        bnd_togg = float(_toggles_packed(sig["bound"]))
        e["binding"] = (dec_togg * c.e_fa_op
                        + bnd_togg * 2.0 * c.e_gate_op
                        + dec_togg * c.e_toggle)
        cnt_togg = float(_toggles_uint(sig["counts"], cnt_bits))
        e["spatial_bundling"] = (bnd_togg * 1.0 * c.e_fa_op
                                 + cnt_togg * c.e_toggle
                                 + float(_toggles_packed(sig["spat"]))
                                 * (c.e_cmp_bit + c.e_ff_toggle))
    else:  # CompIM datapaths
        rom_bits_read = C_ch * S * pos_bits       # 56 bits per channel
        pos_togg = float(_toggles_uint(sig["im_out"], pos_bits))
        e["im"] = rom_bits_read * c.e_rom_bit_read + pos_togg * c.e_toggle
        e["decoder"] = 0.0
        bpos_togg = float(_toggles_uint(sig["bound_pos"], pos_bits))
        demux_togg = float(_toggles_packed(sig["bound"]))   # one-hot outputs
        e["binding"] = (bpos_togg * c.e_fa_op                     # 7-bit adds
                        + demux_togg * 2.0 * c.e_gate_op          # 7->128 demux
                        + bpos_togg * c.e_toggle)
        if variant == "sparse_compim":
            cnt_togg = float(_toggles_uint(sig["counts"], cnt_bits))
            e["spatial_bundling"] = (demux_togg * 1.0 * c.e_fa_op
                                     + cnt_togg * c.e_toggle
                                     + float(_toggles_packed(sig["spat"]))
                                     * (c.e_cmp_bit + c.e_ff_toggle))
        else:  # OR trees, no threshold
            e["spatial_bundling"] = (demux_togg * 2.0 * c.e_gate_op
                                     + float(_toggles_packed(sig["spat"])) * c.e_ff_toggle)

    # temporal bundling: counter FF toggles + incrementer activity (shared)
    tcnt_togg = float(_toggles_uint(sig["tcnt"], tmp_bits))
    spat_ones = _mean_ones(sig["spat"])
    e["temporal_bundling"] = (tcnt_togg * c.e_ff_toggle
                              + spat_ones * c.e_fa_op * 1.5       # ripple increment
                              + D * tmp_bits * c.e_ff_clk)        # clock tree
    # AM: evaluated once per frame (2 sequential class compares) -> amortize
    fh = sig["frame_hv"]
    fh_togg = float(_toggles_packed(fh)) if fh.shape[0] > 1 else float(D) * 0.25
    gate_e = c.e_gate_op if variant != "dense" else c.e_gate_op * 2.0
    mean_q_ones = _mean_ones(fh)
    am_per_frame = (cfg.n_classes * (D * gate_e * 0.5 + mean_q_ones * c.e_fa_op * 2.0)
                    + fh_togg * c.e_ff_toggle + 64 * c.e_cmp_bit)
    e["am"] = am_per_frame / W                                    # per cycle

    e["control"] = 0.05 * sum(e.values())
    # fJ/cycle -> nJ per prediction (= window cycles)
    return {k: v * W * 1e-6 for k, v in e.items()}


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def report(variant: str, params, codes, cfg: HDCConfig,
           c: HWConstants = C16, e_scale: float = 1.0, a_scale: float = 1.0) -> dict:
    area = {k: v * a_scale for k, v in area_inventory(variant, cfg, c).items()}
    energy = {k: v * e_scale
              for k, v in energy_per_prediction(variant, params, codes, cfg, c).items()}
    total_a, total_e = sum(area.values()), sum(energy.values())
    cycles = cfg.window + cfg.n_classes
    return {
        "variant": variant,
        "area_um2": area,
        "area_total_mm2": total_a / 1e6,
        "energy_nj": energy,
        "energy_total_nj": total_e,
        "energy_breakdown": {k: v / total_e for k, v in energy.items()},
        "area_breakdown": {k: v / total_a for k, v in area.items()},
        "latency_us_at_10mhz": cycles / 10.0,
        "energy_per_channel_nj": total_e / cfg.channels,
    }


def calibration_factors(params_sparse, codes, cfg: HDCConfig, c: HWConstants = C16,
                        target_e_nj: float = 12.5,
                        target_a_mm2: float = 0.059) -> tuple[float, float]:
    """Anchor the model's absolute scale to the paper's published numbers
    for the optimised design (12.5 nJ a prediction, 0.059 mm^2 in 16nm at
    0.75 V).  Only the global scale is calibrated: per-module structure and
    the ratios between variants stay the model's own."""
    r = report("sparse_opt", params_sparse, codes, cfg, c)
    return target_e_nj / r["energy_total_nj"], target_a_mm2 / r["area_total_mm2"]
