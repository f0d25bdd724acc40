"""K1/K2: the transposition unit (horizontal <-> vertical layout).

Counterpart of :mod:`repro.kernels.transpose_kernel` (``h2v_pallas`` /
``v2h_pallas``, a SWAR 32x32 bit transpose per tile).  The CUDA kernels
are in ``csrc/transpose.cu``: both run the SWAR network in registers and
across lanes with warp shuffles, with every 16-byte load issued first;
K2 also sign-extends in its store when asked.  The plain versions beside
them run the same SWAR network as the reference, on int32 bit-views of
the uint32 words.

Layout contract (as :func:`repro_torch.core.bitplane.pack`):
  values (N,) int32       lane l's value (N a multiple of 32)
  planes (k, N/32) int32  plane j, word b holds bit j of lanes 32b..32b+31
                          (lane l at bit l % 32)

Both wrappers take a tensor and run its device: the plain version for a
CPU tensor, the kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import build

_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_DELTAS = (16, 8, 4, 2, 1)


def _srl(x: torch.Tensor, j: int) -> torch.Tensor:
    """Logical right shift of int32 bit-views (int32 ``>>`` is arithmetic)."""
    return (x >> j) & ((1 << (32 - j)) - 1)


def _swar_network(x: torch.Tensor) -> torch.Tensor:
    """Hacker's-Delight 32x32 bit transpose over (B, 32) int32 tiles:
    out[:, r] bit c = x[:, 31-c] bit 31-r (the anti-diagonal transpose)."""
    idx = torch.arange(32, device=x.device)
    for j, m in zip(_DELTAS, _MASKS):
        is_low = (idx & j) == 0
        xp = x[:, idx ^ j]
        new_low = x ^ ((x ^ _srl(xp, j)) & m)
        new_high = x ^ (((xp ^ _srl(x, j)) & m) << j)
        x = torch.where(is_low[None, :], new_low, new_high)
    return x


def _swar_transpose_tile(x: torch.Tensor) -> torch.Tensor:
    """Main-diagonal transpose of (B, 32) tiles: y[b, j] bit l = bit j of
    row l of tile b (the row reversals turn the network's anti-diagonal
    transpose into the main-diagonal one)."""
    return _swar_network(x.flip(1)).flip(1)


def h2v_plain(values: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """(N,) int32 lane values -> (n_bits, N/32) int32 planes."""
    n = values.shape[0]
    assert n % 32 == 0
    tiles = values.reshape(n // 32, 32)
    return _swar_transpose_tile(tiles).T[:n_bits].contiguous()


def v2h_plain(planes: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """(k <= 32, W) int32 planes -> (32 W,) int32 lane values; planes k..31
    read as zero, and ``signed`` sign-extends from bit k - 1 for k < 32,
    as the reference's ``ops.v2h(signed=True)`` does (a 1-bit value is
    then {0, -1}; a 32-bit value is already its two's-complement view)."""
    k, w = planes.shape
    full = torch.zeros((32, w), dtype=torch.int32, device=planes.device)
    full[:k] = planes
    vals = _swar_transpose_tile(full.T.contiguous()).reshape(32 * w)
    if signed and k < 32:
        return vals - (((vals >> (k - 1)) & 1) << k)
    return vals


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 tensor, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} is on unsupported device {t.device}")


def h2v_cuda(values: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """K1: (N,) int32 lane values, N a multiple of 32 -> (n_bits, N/32)."""
    _check(values, "values")
    n = values.shape[0]
    if n % 32 or not 1 <= n_bits <= 32:
        raise ValueError(f"h2v needs N % 32 == 0 and 1 <= n_bits <= 32, got "
                         f"N={n}, n_bits={n_bits}")
    if values.device.type == "cpu":
        return h2v_plain(values, n_bits)
    if values.data_ptr() % 16:        # the kernel reads 16-byte vectors
        values = values.clone()
    planes = torch.empty((n_bits, n // 32), dtype=torch.int32,
                         device=values.device)
    if n:
        build.launch("transpose", "h2v_launch", values.data_ptr(),
                     planes.data_ptr(), n // 32, n_bits)
        build.LAUNCHES["h2v"] += 1
    return planes


def v2h_cuda(planes: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """K2: (k <= 32, W) int32 planes -> (32 W,) int32 lane values; planes
    k..31 read as zero; ``signed`` sign-extends as :func:`v2h_plain`."""
    _check(planes, "planes")
    k, w = planes.shape
    if not 1 <= k <= 32:
        raise ValueError(f"v2h takes 1..32 planes, got {k}")
    if planes.device.type == "cpu":
        return v2h_plain(planes, signed)
    values = torch.empty((32 * w,), dtype=torch.int32, device=planes.device)
    if w:
        build.launch("transpose", "v2h_launch", planes.data_ptr(),
                     values.data_ptr(), w, k, int(signed))
        build.LAUNCHES["v2h"] += 1
    return values
