"""Public wrappers for the port's kernels (padding, sign extension, dispatch).

Counterpart of :mod:`repro.kernels.ops`:

  bbop_cuda   any of the 16 SIMDRAM ops: h2v (K1) per operand, the fused
              circuit (K3), v2h (K2) per output; the analogue of
              ``bbop_pallas``
  h2v / v2h   the transposition unit (K1/K2)
  bitserial_matmul / quantized_matmul
              integer matmuls as sums of binary popcount matmuls (K4)

Each wrapper runs the device its input tensors are on: the kernels for
CUDA tensors, the plain versions for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitplane import _compiled_op, host_i32, to_i32_bits
from .bitplane_ops import circuit_on_planes
from .bitserial_matmul import binary_matmul
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
    two's-complement view)."""
    k = planes.shape[0]
    vals = v2h_cuda(planes.contiguous())
    if signed and k < 32:
        sign = (vals >> (k - 1)) & 1
        return vals - (sign << k)
    return vals


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

    Decomposes into ``a_bits * w_bits`` binary popcount matmuls, one K4
    launch each (on CUDA tensors); the MSB planes of signed operands carry
    negative weight, and the int32 sum wraps as the reference's does.
    Operands are tensors (run on their device) or host arrays (run on
    ``device``, default ``"cuda"``).  The reference's TPU tile arguments
    (``bm``, ``bn``, ``bk``, ``interpret``) have no counterpart: K is
    padded to whole words only."""
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

    w_planes = [_pack_bits_matrix((wu >> j) & 1, axis_k=0)
                for j in range(w_bits)]                       # (Kw, N)
    out = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    for i in range(a_bits):
        sa = -1 if (a_signed and i == a_bits - 1) else 1
        a_planes = _pack_bits_matrix((au >> i) & 1, axis_k=1)   # (M, Kw)
        for j in range(w_bits):
            sw = -1 if (w_signed and j == w_bits - 1) else 1
            part = binary_matmul(a_planes, w_planes[j])
            out = out + (sa * sw) * (part << (i + j))
    return out


# float64 represents every integer below 2**53 exactly
_F64_EXACT = 1 << 53


def quantized_matmul(a, w, a_bits: int, w_bits: int, **kw) -> torch.Tensor:
    """Offload-style dispatch (the paper's section 4 decision): bit-serial
    for very low precision (``a_bits * w_bits <= 4``, the reference's
    rule), else a plain integer matmul.

    PyTorch has no int32 matmul on CUDA, so the plain branch takes an
    exact route: a float64 ``torch.matmul``, which is exact while every
    partial sum stays below 2**53 — guaranteed when
    ``K * max|a| * max|w| < 2**53`` (with values inside their widths,
    ``K (2^a_bits - 1)(2^w_bits - 1) < 2**53``), checked here and raised
    beyond — then int64, then the low 32 bits as int32: the wrap of the
    reference's ``jnp.dot(..., preferred_element_type=int32)``, whose
    int32 sum equals the true sum modulo 2**32."""
    if a_bits * w_bits <= 4:
        return bitserial_matmul(a, w, a_bits, w_bits, **kw)
    device = kw.get("device")
    a = _matmul_operand(a, device)
    w = _matmul_operand(w, a.device if device is None else device)
    k = a.shape[1]
    amax = int(a.to(torch.int64).abs().max()) if a.numel() else 0
    wmax = int(w.to(torch.int64).abs().max()) if w.numel() else 0
    if k * amax * wmax >= _F64_EXACT:
        raise ValueError(
            f"K * max|a| * max|w| = {k * amax * wmax} reaches 2**53: a "
            "float64 matmul would not be exact")
    exact = torch.matmul(a.to(torch.float64), w.to(torch.float64))
    return to_i32_bits(exact.to(torch.int64))


def to_host(result):
    """A wrapper's tensor result(s) as host numpy arrays."""
    if isinstance(result, tuple):
        return tuple(np.asarray(r.cpu()) for r in result)
    return np.asarray(result.cpu())
