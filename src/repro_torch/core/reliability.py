"""Process-variation reliability Monte-Carlo (paper §5 reliability study).

A triple-row activation computes MAJ by charge sharing: three cells (charge
±Vdd/2 around the bitline precharge level) plus the bitline capacitance
settle to a voltage whose sign the sense amplifier resolves.  Nominally

    V_deviation ∝ (n_ones - n_zeros)/3 · Cc/(3·Cc + Cb)

Manufacturing variation perturbs each cell's capacitance and the
sense-amp offset.  We model (per the paper's methodology, SPICE replaced by
a vectorized Monte-Carlo over the same first-order charge equation):

  - cell capacitance  Cc_i ~ N(Cc, (σ·Cc)²)      [σ = process variation]
  - bitline capacitance Cb ~ N(Cb, (σ·Cb)²)
  - sense-amp offset   V_off ~ N(0, σ_sa²)

A TRA fails when the settled deviation has the wrong sign for the
majority value.  :func:`tra_failure_rate` sweeps σ; the benchmark shows the
paper's qualitative result — correct operation margin survives technology
scaling (smaller Cc/Cb ratios) until variation grows past ~±20 %.

Determinism: the random stream is generated from NumPy's Philox counter
engine via ``random_raw`` — a documented, version-stable raw uint64
stream — with uniforms and Box–Muller normals derived here, instead of
``Generator.integers``/``standard_normal`` whose output is only
guaranteed stable within one NumPy version stream policy.  The same
(seed, n_trials) therefore reproduces bit-identical failure rates across
NumPy releases, which lets CI gate on exact values and lets the fault
layer (:mod:`repro_torch.core.fault`) derive its per-activation flip
probability reproducibly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class CellModel:
    cc_ff: float = 22.0      # cell capacitance (fF)
    cb_ff: float = 85.0      # bitline capacitance (fF)
    vdd: float = 1.2
    sa_offset_mv: float = 5.0  # sense-amp offset sigma


# technology nodes: scaled cell/bitline capacitance (smaller = harder)
TECH_NODES = {
    "22nm": CellModel(cc_ff=24.0, cb_ff=92.0),
    "17nm": CellModel(cc_ff=22.0, cb_ff=85.0),
    "14nm": CellModel(cc_ff=20.0, cb_ff=78.0),
    "10nm": CellModel(cc_ff=17.0, cb_ff=70.0),
    "7nm":  CellModel(cc_ff=14.5, cb_ff=62.0),
}

# the 8 TRA input combinations, weighted equally; only the 2-vs-1 cases
# have margin risk (3-0 cases have 3× margin)
_PATTERNS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], [1, 1, 0],
     [0, 1, 0], [1, 0, 0]],
    dtype=np.float64,
)


def _raw_stream(seed: int, n: int) -> np.ndarray:
    """``n`` raw uint64 draws from the Philox counter engine — the
    version-stable primitive every derived quantity builds on."""
    return np.random.Philox(key=seed).random_raw(n)


def _uniforms(raw: np.ndarray, open_left: bool = False) -> np.ndarray:
    """53-bit uniforms in [0, 1) — or (0, 1] with ``open_left`` (the
    Box–Muller log argument must never be 0)."""
    u = (raw >> np.uint64(11)).astype(np.float64)
    if open_left:
        return (u + 1.0) * (2.0 ** -53)
    return u * (2.0 ** -53)


def _normals(raw1: np.ndarray, raw2: np.ndarray) -> np.ndarray:
    """Standard normals via Box–Muller from two raw streams."""
    u1 = _uniforms(raw1, open_left=True)
    u2 = _uniforms(raw2)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def _simulate(sigma_frac: float, cell: CellModel, n_trials: int, seed: int):
    """One Monte-Carlo run: returns (pattern indices, failure flags)."""
    # one contiguous raw block per logical variable, so every draw is a
    # pure function of (seed, n_trials) — no rejection, no state
    raw = _raw_stream(seed, n_trials * 9)
    idx = raw[:n_trials] % np.uint64(len(_PATTERNS))   # 8 | 2^64: unbiased
    idx = idx.astype(np.int64)
    bits = _PATTERNS[idx]                     # (T, 3) in {0,1}
    maj = (bits.sum(axis=1) >= 2.0)

    def block(k):
        return raw[(k + 1) * n_trials:(k + 2) * n_trials]

    cc_n = np.stack([_normals(block(2 * j), block(2 * j + 1))
                     for j in range(3)], axis=1)        # (T, 3)
    cc = np.maximum(cell.cc_ff * (1.0 + sigma_frac * cc_n), 1e-3)
    cb_n = _normals(block(6), block(7))
    cb = np.maximum(cell.cb_ff * (1.0 + sigma_frac * cb_n), 1e-3)
    # charge per cell: +Vdd/2 for 1, -Vdd/2 for 0 (deviation from precharge)
    q = ((bits * 2.0) - 1.0) * (cell.vdd / 2.0) * cc      # (T, 3)
    v_dev = q.sum(axis=1) / (cc.sum(axis=1) + cb) * 1e3   # mV
    # reuse of the idx block for the offset would correlate draws; the
    # 9th block is reserved for it
    raw_off = _raw_stream(seed + 0x9E3779B9, n_trials * 2)
    v_off = cell.sa_offset_mv * _normals(raw_off[:n_trials],
                                         raw_off[n_trials:])
    fail = ((v_dev + v_off) > 0.0) != maj
    return idx, fail


def tra_failure_rate(
    sigma_frac: float,
    cell: CellModel = TECH_NODES["17nm"],
    n_trials: int = 200_000,
    seed: int = 0,
) -> float:
    """P(TRA resolves the wrong majority) under σ process variation.
    Bit-identical across NumPy versions for fixed (seed, n_trials)."""
    _, fail = _simulate(sigma_frac, cell, n_trials, seed)
    return float(np.mean(fail))


def tra_failure_breakdown(
    sigma_frac: float,
    cell: CellModel = TECH_NODES["17nm"],
    n_trials: int = 200_000,
    seed: int = 0,
) -> Dict[str, float]:
    """Per-input-pattern failure rates plus the ``overall`` rate —
    the decomposition the fault model consumes (and the paper's
    observation made quantitative: all failures concentrate in the six
    2-vs-1 patterns; the unanimous patterns' 3× margin holds until far
    larger σ)."""
    idx, fail = _simulate(sigma_frac, cell, n_trials, seed)
    out: Dict[str, float] = {"overall": float(np.mean(fail))}
    for p in range(len(_PATTERNS)):
        name = "".join(str(int(b)) for b in _PATTERNS[p])
        sel = idx == p
        n = int(sel.sum())
        out[name] = float(fail[sel].mean()) if n else 0.0
    return out


def sweep(sigmas=(0.0, 0.05, 0.10, 0.15, 0.20, 0.25), nodes=None, n_trials=200_000):
    nodes = nodes or TECH_NODES
    out = {}
    for name, cell in nodes.items():
        out[name] = {s: tra_failure_rate(s, cell, n_trials) for s in sigmas}
    return out
