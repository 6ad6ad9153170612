"""The 16nm gate-energy constants the ECC cost model prices reads with
(port of the part of ``repro.core.hwmodel`` that ``reliability/ecc.py``
needs: ``HWConstants``, ``C16`` and ``gate_energy_fj``).

The rest of the reference module, the per-variant area inventory and the
switching-activity simulation, is not ported yet.  The constants are
order-of-magnitude 16nm FinFET proxies at 0.75 V / 10 MHz, as in the
reference: the model is read by ratios (ECC overhead against the raw AM
read), not by absolute nJ.
"""

from __future__ import annotations

from dataclasses import dataclass


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
