"""K4: the binary popcount matmul of SIMDRAM's NN-kernel engine.

Counterpart of :mod:`repro.kernels.bitserial_matmul`.  An integer matmul
decomposes over bit-planes,

    A.W = sum_{i<a_bits, j<w_bits} s_i s_j 2^(i+j) popcount-matmul(A_i, W_j)

where A_i, W_j are bit-packed binary matrices (32 features per word) and
popcount-matmul is out[m,n] = sum_k popcount(a[m,k] & w[k,n]): the
paper's AND + bitcount inner loop.  :func:`binary_matmul` computes one
such product, :func:`bitserial_planes` the whole weighted sum over plane
pairs in one launch; both run the CUDA kernel in ``csrc/popmatmul.cu``
(tensor-core ``mma .b1 .and.popc``) for CUDA tensors and their plain
versions, :func:`repro_torch.kernels.ref.binary_matmul_ref` and
:func:`~repro_torch.kernels.ref.bitserial_planes_ref`, for CPU tensors.
Words are int32 bit-views of the reference's uint32 words.

The reference pads K to its tile depth and M/N to its tile sizes for the
TPU; the kernel masks ragged shapes itself, so callers pad K only to whole
words.
"""

from __future__ import annotations

import torch

from . import build
from .ref import binary_matmul_ref, bitserial_planes_ref


def _operands(a: torch.Tensor, w: torch.Tensor, dim: int):
    for t, what in ((a, "a"), (w, "w")):
        if t.dtype != torch.int32 or t.dim() != dim:
            raise ValueError(f"{what} must be a {dim}-D int32 tensor, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if a.shape[-1] != w.shape[-2]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} x "
                         f"{tuple(w.shape)}")
    if a.device != w.device:
        raise ValueError(f"a on {a.device}, w on {w.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    return a.contiguous(), w.contiguous()


def _launch(a, w, n_a: int, n_w: int, a_signed: bool,
            w_signed: bool) -> torch.Tensor:
    m, kw = a.shape[-2:]
    n = w.shape[-1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m and n:
        build.launch("popmatmul", "popmatmul_launch", a.data_ptr(),
                     w.data_ptr(), out.data_ptr(), m, n, kw, n_a, n_w,
                     int(a_signed), int(w_signed))
        build.LAUNCHES["popmatmul"] += 1
    return out


def binary_matmul(a_words: torch.Tensor,
                  w_words: torch.Tensor) -> torch.Tensor:
    """out[m,n] = sum_k popcount(a_words[m,k] & w_words[k,n]).

    a_words: (M, Kw) int32 words, w_words: (Kw, N) int32 words, on one
    device -> (M, N) int32 on it.  Any shapes: the kernel masks ragged
    edges."""
    a_words, w_words = _operands(a_words, w_words, 2)
    if a_words.device.type == "cpu":
        return binary_matmul_ref(a_words, w_words)
    return _launch(a_words, w_words, 1, 1, False, False)


def bitserial_planes(a_planes: torch.Tensor, w_planes: torch.Tensor,
                     a_signed: bool = False,
                     w_signed: bool = False) -> torch.Tensor:
    """sum_{i,j} s_i s_j 2^(i+j) binary_matmul(a_planes[i], w_planes[j]),
    wrapped to int32 as the reference's ``bitserial_matmul`` sums it; s is
    -1 on the last plane of a signed operand.

    a_planes: (n_a, M, Kw) int32 words, w_planes: (n_w, Kw, N), on one
    device, n_a and n_w at most 32 -> (M, N) int32; one kernel launch on
    a card."""
    a_planes, w_planes = _operands(a_planes, w_planes, 3)
    n_a, n_w = a_planes.shape[0], w_planes.shape[0]
    if not (1 <= n_a <= 32 and 1 <= n_w <= 32):
        raise ValueError(f"1..32 planes per operand, got {n_a} and {n_w}")
    if a_planes.device.type == "cpu":
        return bitserial_planes_ref(a_planes, w_planes, a_signed, w_signed)
    return _launch(a_planes, w_planes, n_a, n_w, a_signed, w_signed)
