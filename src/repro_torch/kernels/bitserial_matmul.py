"""K4: the binary popcount matmul of SIMDRAM's NN-kernel engine.

Counterpart of :mod:`repro.kernels.bitserial_matmul`.  An integer matmul
decomposes over bit-planes,

    A.W = sum_{i<a_bits, j<w_bits} s_i s_j 2^(i+j) popcount-matmul(A_i, W_j)

where A_i, W_j are bit-packed binary matrices (32 features per word) and
popcount-matmul is out[m,n] = sum_k popcount(a[m,k] & w[k,n]): the
paper's AND + bitcount inner loop.  :func:`binary_matmul` computes it with
the CUDA kernel in ``csrc/popmatmul.cu`` for CUDA tensors and with its
plain version, :func:`repro_torch.kernels.ref.binary_matmul_ref`, for CPU
tensors.  Words are int32 bit-views of the reference's uint32 words.

The reference pads K to its tile depth and M/N to its tile sizes for the
TPU; the kernel masks ragged shapes itself, so callers pad K only to whole
words.
"""

from __future__ import annotations

import torch

from . import build
from .ref import binary_matmul_ref


def binary_matmul(a_words: torch.Tensor,
                  w_words: torch.Tensor) -> torch.Tensor:
    """out[m,n] = sum_k popcount(a_words[m,k] & w_words[k,n]).

    a_words: (M, Kw) int32 words, w_words: (Kw, N) int32 words, on one
    device -> (M, N) int32 on it.  Any shapes: the kernel masks ragged
    edges."""
    for t, what in ((a_words, "a_words"), (w_words, "w_words")):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{what} must be a 2-D int32 tensor, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if a_words.shape[1] != w_words.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a_words.shape)} "
                         f"x {tuple(w_words.shape)}")
    if a_words.device != w_words.device:
        raise ValueError(f"a_words on {a_words.device}, w_words on "
                         f"{w_words.device}")
    a_words, w_words = a_words.contiguous(), w_words.contiguous()
    if a_words.device.type == "cpu":
        return binary_matmul_ref(a_words, w_words)
    if a_words.device.type != "cuda":
        raise ValueError(f"unsupported device {a_words.device}")
    m, kw = a_words.shape
    n = w_words.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a_words.device)
    if m and n:
        build.launch("popmatmul", "popmatmul_launch", a_words.data_ptr(),
                     w_words.data_ptr(), out.data_ptr(), m, n, kw)
        build.LAUNCHES["popmatmul"] += 1
    return out
