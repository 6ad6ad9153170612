"""LM data: input stand-ins on the ``meta`` device and synthetic batches.

The four input shapes map to step kinds:

  train_4k     seq 4,096   gb 256   -> train step
  prefill_32k  seq 32,768  gb 32    -> prefill
  decode_32k   seq 32,768  gb 128   -> decode_step (cache = seq)
  long_500k    seq 524,288 gb 1     -> decode_step (cache = seq; SSM/hybrid only)

Modality conventions (the frontends are stubs fed with precomputed
embeddings):

  vlm    ``media`` (B, M, d_model) patch embeddings; text length = seq - M so
         the backbone sees exactly ``seq`` positions.
  audio  ``frames`` (B, seq, d_model) to the encoder; decoder text length =
         seq // 8 for train/prefill (an ASR-like 8:1 frame-to-token ratio).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.models import serve as serve_mod
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def text_len(cfg: ArchConfig, seq: int, kind: str) -> int:
    if cfg.family == "vlm":
        return seq - cfg.num_media_tokens
    if cfg.family in ("encdec", "audio") and kind != "decode":
        return max(seq // 8, 16)
    return seq


def enc_len(seq: int) -> int:
    """The encoder length of a decode step's cross caches at context ``seq``
    (the text length's 8:1 ratio, as the reference sizes them)."""
    return max(seq // 8, 16)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for every model input on the ``meta`` device (shapes and
    dtypes, no allocation: a 32k-context decode cache of command-r is about
    half a terabyte)."""
    b, seq = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tl = text_len(cfg, seq, shape.kind)

    def meta(*shp, dtype=torch.float32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        spec = {"tokens": meta(b, tl, dtype=torch.int32)}
        if shape.kind == "train":
            spec["labels"] = meta(b, tl, dtype=torch.int32)
        if cfg.family == "vlm":
            spec["media"] = meta(b, cfg.num_media_tokens, d)
        if cfg.family in ("encdec", "audio"):
            spec["frames"] = meta(b, seq, d)
        return spec
    caches = serve_mod.init_caches(cfg, b, seq, getattr(torch, cfg.dtype), device="meta",
                                   enc_len=enc_len(seq))
    return {"tokens": meta(b, 1, dtype=torch.int32), "caches": caches,
            "pos": meta(dtype=torch.int32)}


def synth_batch(generator: torch.Generator, cfg: ArchConfig, shape: ShapeSpec,
                batch_override: int | None = None) -> dict:
    """A random batch on the generator's device (tokens, then labels, then
    media or frames, drawn in that order).  A decode batch holds zero caches
    of ``seq_len`` (cross caches of ``enc_len(seq_len)``) and
    ``pos = seq_len // 2``."""
    b = batch_override or shape.global_batch
    seq = shape.seq_len
    tl = text_len(cfg, seq, shape.kind)
    dev = generator.device

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=generator, device=dev,
                             dtype=torch.int32)

    out: dict = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = tokens(tl)
        if shape.kind == "train":
            out["labels"] = tokens(tl)
        if cfg.family == "vlm":
            out["media"] = torch.randn((b, cfg.num_media_tokens, cfg.d_model),
                                       generator=generator, device=dev)
        if cfg.family in ("encdec", "audio"):
            out["frames"] = torch.randn((b, seq, cfg.d_model), generator=generator,
                                        device=dev)
        return out
    out["tokens"] = tokens(1)
    out["pos"] = seq // 2
    out["caches"] = serve_mod.init_caches(cfg, b, seq, getattr(torch, cfg.dtype), dev,
                                          enc_len=enc_len(seq))
    return out


def batch_for_step(cfg: ArchConfig, shape: ShapeSpec, step: int,
                   batch_override: int | None = None, device=None) -> dict:
    """A pure function of (config, step, device): a generator seeded by the
    step on ``device`` (default: the card), so a restart at step k draws the
    same batch."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(step)
    return synth_batch(gen, cfg, shape, batch_override)
