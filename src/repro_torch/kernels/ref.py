"""Plain torch oracles for the port's kernels.

Counterpart of :mod:`repro.kernels.ref`.  Words are int32 bit-views of
the reference's uint32 words.  :func:`popcount_u32` runs the reference's
SWAR popcount in int64: the multiply by 0x01010101 overflows int32 and
int32 ``>>`` is arithmetic, while in int64 neither happens, and the
count is the byte at bits 24..31.
"""

from __future__ import annotations

import torch


def transpose32_ref(values: torch.Tensor) -> torch.Tensor:
    """h2v oracle: (N,) int32 lane values -> (32, N//32) int32 planes."""
    from ..core.bitplane import to_i32_bits

    n = values.shape[0]
    assert n % 32 == 0
    v = values.to(torch.int64).reshape(n // 32, 32)          # [block, lane]
    shifts = torch.arange(32, dtype=torch.int64, device=values.device)
    bits = (v[:, :, None] >> shifts) & 1                     # [block, lane, j]
    # planes[j, b] = sum_l bit_j(v[b, l]) << l
    planes = (bits << shifts[None, :, None]).sum(dim=1)
    return to_i32_bits(planes.T.contiguous())


_M1, _M2, _M4, _H01 = 0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word (any int dtype; its low 32 bits)
    -> int32."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * _H01) >> 24 & 0xFF).to(torch.int32)


# elements of the (rows, Kw, N) AND-ed block binary_matmul_ref holds at once
_PLAIN_CHUNK = 1 << 24


def binary_matmul_ref(a_words: torch.Tensor,
                      w_words: torch.Tensor) -> torch.Tensor:
    """out[m,n] = sum_k popcount(a_words[m,k] & w_words[k,n]).

    a_words: (M, Kw) int32 words — M lanes, K = 32 Kw binary features
    w_words: (Kw, N) int32 words
    returns: (M, N) int32

    The plain version of K4: the AND-ed (M, Kw, N) block, popcounted and
    summed over Kw, in row chunks that keep the block small.
    """
    m, kw = a_words.shape
    n = w_words.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a_words.device)
    rows = max(1, _PLAIN_CHUNK // max(1, kw * n))
    for r in range(0, m, rows):
        anded = a_words[r: r + rows, :, None] & w_words[None, :, :]
        out[r: r + rows] = popcount_u32(anded).sum(dim=1).to(torch.int32)
    return out


def bitserial_planes_ref(a_planes: torch.Tensor, w_planes: torch.Tensor,
                         a_signed: bool = False,
                         w_signed: bool = False) -> torch.Tensor:
    """The plain version of K4's fused entry: sum over plane pairs of
    s_i s_j 2^(i+j) binary_matmul_ref(a_planes[i], w_planes[j]), modulo
    2**32, as int32 (s = -1 on the last plane of a signed operand; a
    weight of 2**32 or more is 0 modulo 2**32).

    a_planes: (n_a, M, Kw) int32 words, w_planes: (n_w, Kw, N) int32
    words.  Each popcount sum is below 2**31 and each weight is taken
    modulo 2**32 first, so every int64 product is exact."""
    from ..core.bitplane import to_i32_bits

    n_a, n_w = a_planes.shape[0], w_planes.shape[0]
    out = torch.zeros((a_planes.shape[1], w_planes.shape[2]),
                      dtype=torch.int64, device=a_planes.device)
    for i in range(n_a):
        sa = -1 if (a_signed and i == n_a - 1) else 1
        for j in range(n_w):
            sw = -1 if (w_signed and j == n_w - 1) else 1
            weight = (sa * sw << (i + j)) & 0xFFFFFFFF
            part = binary_matmul_ref(a_planes[i], w_planes[j])
            out = (out + part.to(torch.int64) * weight) & 0xFFFFFFFF
    return to_i32_bits(out)


def bitserial_matmul_ref(
    a: torch.Tensor, w: torch.Tensor, a_bits: int, w_bits: int,
    a_signed: bool = False, w_signed: bool = True,
) -> torch.Tensor:
    """Integer matmul computed bit-serially (the SIMDRAM NN formulation).

    a: (M, K) int — activations, values must fit a_bits
    w: (K, N) int — weights, values must fit w_bits
    out[m,n] = sum_k a[m,k] w[k,n] == sum_{i,j} s_i s_j 2^(i+j) (a_i . w_j)
    where a_i is bit-plane i and the MSB plane of a signed operand carries
    weight -2^(bits-1) (two's complement).  The plane products run as
    int64 matmuls (exact on the CPU; the card has no integer matmul, so
    this oracle is for CPU tensors) and the sum wraps to int32 as the
    reference's does.
    """
    m, k = a.shape
    k2, n = w.shape
    assert k == k2
    a_signed = a_signed and a_bits > 1   # 1-bit operands are unsigned {0,1}
    w_signed = w_signed and w_bits > 1
    au = a.to(torch.int32) & ((1 << a_bits) - 1)
    wu = w.to(torch.int32) & ((1 << w_bits) - 1)
    out = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    for i in range(a_bits):
        sa = -1 if (a_signed and i == a_bits - 1) else 1
        abit = ((au >> i) & 1).to(torch.int64)
        for j in range(w_bits):
            sw = -1 if (w_signed and j == w_bits - 1) else 1
            wbit = ((wu >> j) & 1).to(torch.int64)
            out = out + (sa * sw) * ((abit @ wbit).to(torch.int32) << (i + j))
    return out


def elementwise_circuit_ref(name: str, n_bits: int, *operands):
    """Oracle for the fused bit-plane elementwise kernel (K3): the port's
    eager ``bitplane`` backend on the CPU, as the reference's oracle is
    its own ``bitplane.bbop``.  Lane values in, int32 lane tensors out
    (a tuple for a multi-output op)."""
    from ..core import bitplane
    return bitplane.bbop(name, n_bits, *operands, device="cpu")
