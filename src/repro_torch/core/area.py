"""DRAM area-overhead model (paper claim: < 1 % DRAM chip area).

SIMDRAM's additions to a commodity DDR4 chip/controller:

  inside DRAM (per bank):
    - B-group compute rows (6 physical rows of 1024)        rows
    - modified B-group row decoder (triple activation)      logic
  in the memory controller:
    - control unit (μProgram memory + sequencer)
    - transposition unit (object buffer + bit-transpose network)

The in-DRAM overhead is what counts against the <1 % claim; controller
logic sits on the CPU die.  Numbers follow the paper's accounting style:
row overhead is exact, decoder overhead uses the Ambit estimate.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AreaModel:
    rows_per_subarray: int = 1024
    compute_rows: int = 6          # T0..T3 + DCC0 + DCC1 (8 addresses)
    constant_rows: int = 2         # C0, C1
    decoder_overhead_frac: float = 0.002   # Ambit: special row decoder ≈0.2%
    controller_mm2: float = 0.04           # control unit + transposition unit
                                           # (28nm synthesis-style estimate)

    @property
    def row_overhead_frac(self) -> float:
        return (self.compute_rows + self.constant_rows) / self.rows_per_subarray

    @property
    def dram_overhead_frac(self) -> float:
        return self.row_overhead_frac + self.decoder_overhead_frac

    def report(self) -> dict:
        return {
            "reserved_rows_frac": round(self.row_overhead_frac, 5),
            "decoder_frac": self.decoder_overhead_frac,
            "total_dram_frac": round(self.dram_overhead_frac, 5),
            "meets_paper_claim_lt_1pct": self.dram_overhead_frac < 0.01,
            "controller_mm2": self.controller_mm2,
        }


DEFAULT_AREA = AreaModel()
