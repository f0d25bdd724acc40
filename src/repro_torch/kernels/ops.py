"""Public wrappers for the port's kernels (padding, sign extension, dispatch).

Counterpart of :mod:`repro.kernels.ops`:

  bbop_cuda   any of the 16 SIMDRAM ops: h2v (K1) per operand, the fused
              circuit (K3), v2h (K2) per output; the analogue of
              ``bbop_pallas``
  h2v / v2h   the transposition unit (K1/K2)
  bitserial_matmul / quantized_matmul
              integer matmuls as sums of binary popcount matmuls, fused
              into one K4 launch

Each wrapper runs the device its input tensors are on: the kernels for
CUDA tensors, the plain versions for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitplane import _compiled_op, host_i32, to_i32_bits
from .bitplane_ops import circuit_on_planes
from .bitserial_matmul import bitserial_planes
from .build import resolve_device
from .transpose_kernel import h2v_cuda, v2h_cuda


def h2v(values: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """Transposition unit, horizontal -> vertical: (N,) int32 lane values
    (any N; lanes pad to a multiple of 32) -> (n_bits, ceil(N/32)) int32.

    The conversion :meth:`repro_torch.core.bank.VerticalOperand.from_values`
    routes through, and the one operand forwarding skips."""
    if not 1 <= n_bits <= 32:
        raise ValueError("h2v packs machine words; use core.subarray for "
                         "wider values")
    v = values.reshape(-1)
    n = v.shape[0]
    if n % 32:
        v = torch.nn.functional.pad(v, (0, 32 - n % 32))
    return h2v_cuda(v.contiguous(), n_bits)


def v2h(planes: torch.Tensor, *, signed: bool = False) -> torch.Tensor:
    """Transposition unit, vertical -> horizontal: (k <= 32, W) int32 planes
    -> (32 W,) int32 values.  Planes k..31 read as zero; ``signed``
    sign-extends from bit k-1 for k < 32 (a 32-bit result is already the
    two's-complement view), inside K2's store on a card."""
    return v2h_cuda(planes.contiguous(), signed)


def _lanes_i32(values, dev: torch.device) -> torch.Tensor:
    """Lane values (host array or tensor) as an int32 bit-view on ``dev``."""
    if isinstance(values, torch.Tensor):
        if values.dtype != torch.int32:
            values = to_i32_bits(values.to(torch.int64))
        return values.to(dev)
    return torch.from_numpy(host_i32(values)).to(dev)


def bbop_cuda(name: str, n_bits: int, *operands, signed_out: bool = False,
              device="cuda"):
    """Execute one SIMDRAM op through the transposition and circuit kernels.

    Operands are host integer arrays (or tensors) of one lane count;
    returns one int32 tensor per output on ``device``.  Output signedness
    follows :func:`repro.core.bitplane.unpack`, which the reference's
    ``bbop_pallas`` uses: a 1-bit output is never sign-extended."""
    dev = resolve_device(device)
    spec, circ, ids = _compiled_op(name, n_bits)
    vals = [_lanes_i32(o, dev) for o in operands]
    n = vals[0].shape[-1]
    planes = [h2v(v, w) for v, w in zip(vals, spec.operand_bits)]
    out_planes = circuit_on_planes(circ, ids, planes)
    outs, pos = [], 0
    for w in spec.out_bits:
        outs.append(v2h(out_planes[pos: pos + w],
                        signed=signed_out and w > 1)[:n])
        pos += w
    return outs[0] if len(outs) == 1 else tuple(outs)


def _matmul_operand(x, device) -> torch.Tensor:
    """A matmul operand as an int32 tensor: a tensor stays on its device
    (``device`` moves it if given); a host array goes to ``device``
    (default ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(dev, torch.int32)
    dev = resolve_device("cuda" if device is None else device)
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=dev)


def _pack_bits_matrix(x: torch.Tensor, axis_k: int) -> torch.Tensor:
    """Pack a {0,1} int matrix along axis ``axis_k`` (a multiple of 32
    long) into int32 words, feature 32 t + l at bit l of word t."""
    x = torch.movedim(x.to(torch.int64), axis_k, -1)
    kw = x.shape[-1] // 32
    x = x.reshape(*x.shape[:-1], kw, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = to_i32_bits((x << shifts).sum(dim=-1))
    return torch.movedim(words, -1, axis_k).contiguous()


def bitserial_matmul(a, w, a_bits: int, w_bits: int, *,
                     a_signed: bool = False, w_signed: bool = True,
                     device=None) -> torch.Tensor:
    """Integer matmul (M, K) x (K, N) -> (M, N) int32, computed bit-serially.

    Decomposes into ``a_bits * w_bits`` binary popcount matmuls, all in one
    K4 launch (:func:`~repro_torch.kernels.bitserial_matmul.bitserial_planes`
    on CUDA tensors); the MSB planes of signed operands carry negative
    weight, and the int32 sum wraps as the reference's does.  Operands are
    tensors (run on their device) or host arrays (run on ``device``,
    default ``"cuda"``).  The reference's TPU tile arguments (``bm``,
    ``bn``, ``bk``, ``interpret``) have no counterpart: K is padded to
    whole words only."""
    a = _matmul_operand(a, device)
    w = _matmul_operand(w, a.device if device is None else device)
    m, k = a.shape
    k2, n = w.shape
    assert k == k2
    # a 1-bit two's-complement type would be {0,-1}: 1-bit operands are
    # always unsigned {0,1}
    a_signed = a_signed and a_bits > 1
    w_signed = w_signed and w_bits > 1
    au = a & ((1 << a_bits) - 1)
    wu = w & ((1 << w_bits) - 1)
    pad = -k % 32            # zero features change no popcount
    au = torch.nn.functional.pad(au, (0, pad))
    wu = torch.nn.functional.pad(wu, (0, 0, 0, pad))
    ia = torch.arange(a_bits, dtype=torch.int32, device=a.device)
    iw = torch.arange(w_bits, dtype=torch.int32, device=a.device)
    a_planes = _pack_bits_matrix((au >> ia[:, None, None]) & 1, axis_k=2)
    w_planes = _pack_bits_matrix((wu >> iw[:, None, None]) & 1, axis_k=1)
    return bitserial_planes(a_planes, w_planes, a_signed, w_signed)


# rows of K per float64 product of 16-bit limbs: a sum of 2 * 2**21 terms
# below 2**31 each stays below 2**53, where float64 is exact
_F64_CHUNK = 1 << 21
_LOW32 = 0xFFFFFFFF


def _wrapped_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of int32 matrices modulo 2**32, as int32: the wrap of the
    reference's ``jnp.dot(..., preferred_element_type=int32)``, exact for
    every input.

    PyTorch has no int32 matmul on CUDA, so each operand splits into
    16-bit limbs, ``x = x_hi 2**16 + x_lo`` with ``x_lo`` in [0, 2**16):
    ``a w = a_lo w_lo + 2**16 (a_lo w_hi + a_hi w_lo) (mod 2**32)``.
    ``a_lo w_lo`` and the two cross products (one product over 2K) are
    float64 matmuls whose terms are below 2**32 and 2**31, so every
    partial sum is an integer below 2**53, exact in any order, while K
    is at most ``_F64_CHUNK``; longer K runs in chunks whose sums are
    taken modulo 2**32 and added."""
    a = a.to(torch.int64)
    w = w.to(torch.int64)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    w_lo, w_hi = w & 0xFFFF, w >> 16
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64,
                      device=a.device)
    for k0 in range(0, a.shape[1], _F64_CHUNK):
        ks = slice(k0, k0 + _F64_CHUNK)
        low = torch.matmul(a_lo[:, ks].double(), w_lo[ks].double())
        cross = torch.matmul(torch.cat([a_lo[:, ks], a_hi[:, ks]], 1).double(),
                             torch.cat([w_hi[ks], w_lo[ks]], 0).double())
        part = low.to(torch.int64) + ((cross.to(torch.int64) & _LOW32) << 16)
        out = (out + part) & _LOW32
    return to_i32_bits(out)


def quantized_matmul(a, w, a_bits: int, w_bits: int, **kw) -> torch.Tensor:
    """Offload-style dispatch (the paper's section 4 decision): bit-serial
    for very low precision (``a_bits * w_bits <= 4``, the reference's
    rule), else a plain integer matmul whose int32 sum wraps as the
    reference's does, for every int32 input (:func:`_wrapped_matmul`)."""
    if a_bits * w_bits <= 4:
        return bitserial_matmul(a, w, a_bits, w_bits, **kw)
    device = kw.get("device")
    a = _matmul_operand(a, device)
    w = _matmul_operand(w, a.device if device is None else device)
    return _wrapped_matmul(a, w)


def to_host(result):
    """A wrapper's tensor result(s) as host numpy arrays."""
    if isinstance(result, tuple):
        return tuple(np.asarray(r.cpu()) for r in result)
    return np.asarray(result.cpu())
