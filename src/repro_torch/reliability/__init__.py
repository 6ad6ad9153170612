"""Reliability layer of the port (port of ``repro.reliability``):

* ``faults``   — BER-parameterised bit-error injection into the fleet's
  memory reads (codebook bank, AM class rows, temporal counters), drawn on
  the fleet's device and applied as plain tensor code around the fleet
  kernel, transient or stuck-at;
* ``ecc``      — parity and Hamming SECDED per packed 32-bit AM word, with
  corrected / detected / uncorrectable accounting and the decode's energy
  priced through ``core/hwmodel.py``;
* ``sweep``    — degradation sweeps (BER x variant x density x scheme)
  replayed through ``StreamingFleet``;
* ``channels`` — electrode fault models and the channel-health monitors
  whose (S, C) masks feed ``StreamingFleet.set_channel_mask`` (numpy).
"""

from repro_torch.reliability.ecc import SCHEMES, decode, encode, n_check_bits
from repro_torch.reliability.faults import FaultConfig, FaultPlan

__all__ = ["FaultConfig", "FaultPlan", "SCHEMES", "decode", "encode",
           "n_check_bits"]
