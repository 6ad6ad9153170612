"""BER-parameterised packed-domain fault injection for the fleet datapath
(port of ``repro.reliability.faults``).

Three memories are faulted independently, in the packed domain, at their
READS (storage is never mutated): the pre-bound codebook bank, the AM class
rows (and their ECC check words) and the carried temporal accumulators
(their low ``counter_bits`` bits only).  Two modes:

* ``transient`` — fresh Bernoulli(ber) flips every step (the host folds the
  round into the seed, ``step_seed``);
* ``stuck``     — persistent cells: a fixed per-tile seed selects a
  Bernoulli(ber) set of stuck cells, each holding a fixed random value, so a
  read returns ``(w & ~sel) | (v & sel)`` and flips at rate ber / 2.

``FaultPlan`` is the campaign's structure (targets, mode, seed, ECC scheme,
counter width); ``FaultConfig`` adds the BER values, which ``with_ber``
moves along a grid.  Same names, validation and seed schedule as the
reference.

The reference draws its masks from ``jax.random`` inside its jitted step;
torch cannot replay that stream.  So the port splits each read transform in
two:

* a **draw** (``draw_step``): per target, the Bernoulli select words and,
  in stuck mode, the stuck values, from per-target ``torch.Generator``s on
  the fleet's device seeded from the one scalar seed (``component_keys``);
* an **apply** (``xor_mask``, ``flip_words``, ``flip_counts``): the XOR, or
  ``(w ^ v) & sel`` for stuck cells, on tensors from any source.

``StepDraw`` holds one step's draws; parity tests fill it with masks drawn
by the reference's own functions.  The effective XOR mask of a stuck
target depends on the words read (the counters a step carries), so a draw
stores the select and value words, never the XOR mask.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import hv
from repro_torch.reliability import ecc

MODES = ("transient", "stuck")
TARGETS = ("tables", "am", "counts")  # index order of the BER vector


@dataclass(frozen=True)
class FaultPlan:
    """Structure of a fault campaign: which targets are faulted at all,
    the mode, the base seed, the AM's ECC scheme (``ecc.SCHEMES``) and the
    faulted counter width (None = ceil(log2(window + 1)), see
    ``counter_bits``)."""

    tables: bool = False
    am: bool = False
    counts: bool = False
    mode: str = "transient"
    seed: int = 0
    ecc: str = "none"
    counts_bits: int | None = None

    @property
    def any_target(self) -> bool:
        return self.tables or self.am or self.counts


@dataclass(frozen=True)
class FaultConfig:
    """A fault campaign: per-target BERs (None = target untouched), fault
    mode, base seed, AM ECC scheme and faulted counter width.

    ``ecc`` may be on with ``am=None`` or BER 0: protection is a hardware
    choice whose decode energy every read pays.  ``counts_bits`` sets the
    faulted counter word's width: by default the value width
    ceil(log2(window + 1)); 8 faults the dense datapath's physical D x 8-bit
    register file."""

    tables: float | None = None
    am: float | None = None
    counts: float | None = None
    mode: str = "transient"
    seed: int = 0
    ecc: str = "none"
    counts_bits: int | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r} must be one of {MODES}")
        ecc.n_check_bits(self.ecc)  # validates the scheme name
        for name in TARGETS:
            ber = getattr(self, name)
            if ber is not None and not 0.0 <= float(ber) <= 1.0:
                raise ValueError(
                    f"{name} BER must be in [0, 1] or None, got {ber!r}")
        if self.counts_bits is not None and not 1 <= self.counts_bits <= 32:
            raise ValueError(
                f"counts_bits must be in [1, 32] or None, got "
                f"{self.counts_bits!r}")

    def plan(self) -> FaultPlan:
        return FaultPlan(tables=self.tables is not None,
                         am=self.am is not None,
                         counts=self.counts is not None,
                         mode=self.mode, seed=self.seed, ecc=self.ecc,
                         counts_bits=self.counts_bits)

    def ber_vector(self) -> np.ndarray:
        """(3,) float32 [tables, am, counts] BERs (0.0 for disabled
        targets)."""
        return np.asarray([float(getattr(self, t) or 0.0) for t in TARGETS],
                          np.float32)

    def with_ber(self, ber: float) -> "FaultConfig":
        """Every enabled target moved to one BER (grid sweeps); disabled
        targets stay off."""
        if not 0.0 <= float(ber) <= 1.0:
            raise ValueError(f"ber={ber!r} must be in [0, 1]")
        return replace(self, **{
            t: (float(ber) if getattr(self, t) is not None else None)
            for t in TARGETS})


def counter_bits(plan: FaultPlan, window: int) -> int:
    """Faulted bit width of one temporal-accumulator counter:
    ``plan.counts_bits`` when set, else the value width
    ceil(log2(window + 1)), where every flip lands in a bit the
    accumulation uses."""
    if plan.counts_bits is not None:
        return plan.counts_bits
    return max(1, int(np.ceil(np.log2(window + 1))))


# ---------------------------------------------------------------------------
# host-side seed schedule
# ---------------------------------------------------------------------------

def step_seed(plan: FaultPlan, *, tile: int, n_tiles: int, phase: int) -> int:
    """Scalar seed of one (tile, round): stuck faults reuse a fixed
    per-tile seed (the same cells every step); transient faults fold the
    round in (fresh flips every step).  The two ranges never collide."""
    if plan.mode == "stuck":
        return plan.seed + tile
    return plan.seed + n_tiles * (1 + phase) + tile


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a seed that differs in one bit gives an
    unrelated 63-bit generator seed."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) >> 1


def component_keys(seed: int, device) -> tuple[torch.Generator, ...]:
    """Per-target generators (``TARGETS`` order) on ``device`` from one
    scalar seed: deterministic, and independent across targets and seeds.
    A CUDA and a CPU generator give different streams for one seed."""
    dev = torch.device(device)
    return tuple(torch.Generator(device=dev).manual_seed(
        _mix64(int(seed) * len(TARGETS) + i)) for i in range(len(TARGETS)))


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WordDraw:
    """One target's drawn fault words, int32 carriers of the read's shape:
    ``sel`` the Bernoulli(ber) flip (transient) or stuck-cell (stuck) mask,
    ``val`` the stuck values (None in transient mode)."""

    sel: torch.Tensor
    val: torch.Tensor | None = None

    def to(self, device) -> "WordDraw":
        return WordDraw(self.sel.to(device),
                        None if self.val is None else self.val.to(device))


@dataclass(frozen=True)
class StepDraw:
    """One step's draws, per target (None where the plan leaves it off):
    the bank, the AM's data rows and check words, the carried counters."""

    tables: WordDraw | None = None
    am: WordDraw | None = None
    am_check: WordDraw | None = None
    counts: WordDraw | None = None

    def to(self, device) -> "StepDraw":
        return StepDraw(**{k: None if v is None else v.to(device)
                           for k, v in vars(self).items()})


def draw_words(generator: torch.Generator, shape: tuple[int, ...], ber, *,
               bits: int = hv.WORD, mode: str = "transient") -> WordDraw:
    """One target's draw: transient, a Bernoulli(ber) flip mask; stuck, a
    Bernoulli(ber) cell mask and Bernoulli(1/2) stuck values, drawn in that
    order from ``generator``.  ``ber == 0`` selects nothing."""
    if mode == "transient":
        return WordDraw(hv.random_flip_mask(generator, shape, float(ber), bits))
    if mode != "stuck":
        raise ValueError(f"mode={mode!r} must be one of {MODES}")
    sel = hv.random_flip_mask(generator, shape, float(ber), bits)
    return WordDraw(sel, hv.random_flip_mask(generator, shape, 0.5, bits))


def draw_step(plan: FaultPlan, ber, seed: int, *, tables_shape, rows_shape,
              counts_shape, window: int, device) -> StepDraw:
    """Every enabled target's draw for one (tile, round) ``seed`` on
    ``device``: the bank (``tables_shape``), the AM rows (``rows_shape``;
    with an ECC scheme, their ``n_check_bits`` check words after them, from
    the same generator) and the counters (``counts_shape``, low
    ``counter_bits`` bits).  ``ber`` is the (3,) ``ber_vector``."""
    g_tab, g_am, g_cnt = component_keys(seed, device)
    out = {}
    if plan.tables:
        out["tables"] = draw_words(g_tab, tuple(tables_shape), ber[0], mode=plan.mode)
    if plan.am:
        out["am"] = draw_words(g_am, tuple(rows_shape), ber[1], mode=plan.mode)
        if plan.ecc != "none":
            out["am_check"] = draw_words(g_am, tuple(rows_shape), ber[1],
                                         bits=ecc.n_check_bits(plan.ecc),
                                         mode=plan.mode)
    if plan.counts:
        out["counts"] = draw_words(g_cnt, tuple(counts_shape), ber[2],
                                   bits=counter_bits(plan, window), mode=plan.mode)
    return StepDraw(**out)


# ---------------------------------------------------------------------------
# apply: the read transforms
# ---------------------------------------------------------------------------

def xor_mask(words: torch.Tensor, draw: WordDraw) -> torch.Tensor:
    """Effective XOR mask such that ``words ^ mask`` is the faulty read:
    the flips (transient), or ``(words ^ val) & sel`` (stuck cells, which
    flip only where the stored bit differs from the stuck value)."""
    if draw.val is None:
        return draw.sel
    return (words ^ draw.val) & draw.sel


def flip_words(words: torch.Tensor, draw: WordDraw) -> torch.Tensor:
    """Faulty read of int32-carried packed words."""
    return words ^ xor_mask(words, draw)


def flip_counts(counts: torch.Tensor, draw: WordDraw) -> torch.Tensor:
    """Faulty read of the int32 temporal accumulators: the draw sets only
    their low ``counter_bits`` bits (the bits the counter bank has), so a
    non-negative value stays in [0, 2**bits)."""
    return flip_words(counts, draw)
