"""Transposition-unit model (paper §4 system integration).

SIMDRAM stores PuM operands *vertically* while the CPU reads/writes
*horizontally*; a transposition unit in the memory controller converts
between layouts on the fly so both coexist.  Counterpart of
:mod:`repro.core.transpose`:

  - the conversion itself (`h2v` / `v2h`), a bit-matrix transpose: the
    plain torch version here (:func:`repro_torch.core.bitplane.pack` /
    ``unpack``) is the reference's jnp one; the K1/K2 kernels run it in
    :mod:`repro_torch.kernels.ops`; and its executable spec,
    :func:`swar_transpose_32x32_np`;
  - its *cost* (`transpose_cost_s`): the unit processes one 64-byte cache
    line per controller cycle, overlapping with DRAM traffic, so cost =
    bytes / channel bandwidth — identical to a plain DRAM stream of the
    same data.  It feeds the offload cost model
    (:mod:`repro_torch.core.costmodel`).
"""

from __future__ import annotations

import numpy as np
import torch

from .timing import DDR4, DramConfig


def h2v(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Horizontal (N,) ints -> vertical (n_bits, N//32) int32 planes."""
    from .bitplane import pack
    return pack(values, n_bits)


def v2h(planes: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Vertical planes -> horizontal ints."""
    from .bitplane import unpack
    return unpack(planes, signed=signed)


def swar_transpose_32x32_np(block: np.ndarray) -> np.ndarray:
    """Classic SWAR bit-matrix transpose of a 32×32 bit block (uint32[32]).

    This is the algorithm the hardware transposition unit implements with
    wiring; kept as an executable spec + oracle for the transpose kernels.
    """
    x = block.astype(np.uint32).copy()
    m = np.uint32(0x0000FFFF)
    j, k = 16, 0
    while j:
        k = 0
        while k < 32:
            # swap j×j sub-blocks
            t = ((x[k + j:k + 2 * j] >> np.uint32(0)) ^ (x[k:k + j] >> np.uint32(j))) & m
            x[k:k + j] ^= (t << np.uint32(j)).astype(np.uint32)
            x[k + j:k + 2 * j] ^= t
            k += 2 * j
        j >>= 1
        m = (m ^ (m << np.uint32(j))).astype(np.uint32) if j else m
    return x


def transpose_bytes(n_elems: int, n_bits: int) -> int:
    return n_elems * n_bits // 8


def transpose_cost_s(n_elems: int, n_bits: int, cfg: DramConfig = DDR4) -> float:
    """Streaming cost of converting n_elems n-bit words between layouts."""
    return transpose_bytes(n_elems, n_bits) / (cfg.channel_bw_gbs * 1e9)
