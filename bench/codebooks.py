"""Each patient's codebooks, drawn by the benchmark from the seed on the
device.  The same tensors go to the program (as ``IMParams`` or
``DenseIMParams``) and to the reference; the program does not draw them."""

from __future__ import annotations

import torch

from bench.ieeg_gen import generator


def draw(seed: int, key: tuple, hdc: dict, device) -> dict:
    """{"item", "elec"}: CompIM positions (C, K, S) and (C, S) uint8 for the
    sparse variants; random dense words (C, K, W) and (C, W) int32 for
    dense."""
    g = generator(seed, device, "codebook", *key)
    c, k = hdc["channels"], 1 << hdc["lbp_bits"]
    if hdc["variant"] == "dense":
        words = hdc["dim"] // 32
        v = torch.randint(0, 1 << 32, (c * (k + 1), words), generator=g, device=device,
                          dtype=torch.int64)
        v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
        return {"item": v[: c * k].reshape(c, k, words).contiguous(),
                "elec": v[c * k:].contiguous()}
    s = hdc["segments"]
    seg_len = hdc["dim"] // s
    v = torch.randint(0, seg_len, (c * (k + 1), s), generator=g, device=device,
                      dtype=torch.int64).to(torch.uint8)
    return {"item": v[: c * k].reshape(c, k, s).contiguous(),
            "elec": v[c * k:].contiguous()}


def to_program(book: dict, hdc: dict):
    """The port's parameter object holding these codebooks."""
    from repro_torch.core.im import DenseIMParams, IMParams

    if hdc["variant"] == "dense":
        return DenseIMParams(item_packed=book["item"], elec_packed=book["elec"], dim=hdc["dim"])
    return IMParams(item_pos=book["item"], elec_pos=book["elec"], dim=hdc["dim"],
                    segments=hdc["segments"])
