"""Quantized NN building blocks over SIMDRAM bbops (paper §5 app kernel).

Convolutions/matmuls use the bit-serial formulation (kernel or analytic
accounting), elementwise stages (ReLU, pooling compare trees) run as
real bbops: each builds a ``Ref``-chained :class:`BbopInstr` queue per
lane shard and drains it through :meth:`SimdramDevice.dispatch`, so the
same code runs on every rung of the backend ladder.  Mirrors the
paper's NN kernels: int8 weights/activations, per-tensor power-of-two
scales.  :func:`run` drives a small conv → ReLU+pool → dense → ReLU
network end-to-end and verifies it against a numpy oracle.

Width plumbing: ReLU inputs must already fit ``n_bits``-bit
two's-complement — out-of-range activations raise ``ValueError``
instead of being silently clipped (the seed-era bug: a clip here
corrupts the network's numerics without failing verification of the
clipped tensor).  Signed max-pooling lowers onto the UNSIGNED ``max``
primitive via the order-preserving bias ``x + 2**(n_bits-1)``, un-biased
in-queue by a final signed subtraction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..core.isa import SimdramDevice, compile_op

from .runtime import (QueueBuilder, gather, n_parallel_units,
                      resolve_device, shard_slices, verify)


def quantize(x: np.ndarray, bits: int = 8, signed: bool = True) -> Tuple[np.ndarray, float]:
    """Symmetric power-of-two quantization."""
    amax = np.abs(x).max() or 1.0
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    scale = 2.0 ** np.floor(np.log2(qmax / amax)) if amax > 0 else 1.0
    q = np.clip(np.round(x * scale), -qmax - 1 if signed else 0, qmax)
    return q.astype(np.int32), float(scale)


def im2col(x: np.ndarray, kh: int, kw: int, stride: int = 1, pad: int = 0) -> Tuple[np.ndarray, int, int]:
    """(C, H, W) -> (out_h*out_w, C*kh*kw) patch matrix."""
    c, h, w = x.shape
    if pad:
        x = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    oh = (x.shape[1] - kh) // stride + 1
    ow = (x.shape[2] - kw) // stride + 1
    cols = np.zeros((oh * ow, c * kh * kw), dtype=x.dtype)
    idx = 0
    for i in range(oh):
        for j in range(ow):
            patch = x[:, i * stride: i * stride + kh, j * stride: j * stride + kw]
            cols[idx] = patch.reshape(-1)
            idx += 1
    return cols, oh, ow


@dataclass
class LayerCost:
    """Bit-serial command accounting for one offloaded layer."""
    name: str
    macs: int            # multiply-accumulates
    elements: int        # elementwise op lanes

    def account_matmul(self, dev: SimdramDevice, n_bits: int = 8) -> None:
        """Charge the device for a bit-serial MAC workload: each MAC is one
        n-bit multiplication + one 2n-bit addition μProgram lane."""
        _, up_mul = compile_op("multiplication", n_bits, dev.style)
        _, up_add = compile_op("addition", 2 * n_bits, dev.style)
        for up in (up_mul, up_add):
            dev._account(up.op_name, up.n_bits, up, self.macs)


def conv2d_int(
    x: np.ndarray, w: np.ndarray, stride: int = 1, pad: int = 0
) -> np.ndarray:
    """Integer conv via im2col + int matmul.  x: (C,H,W), w: (O,C,kh,kw)."""
    o, c, kh, kw = w.shape
    cols, oh, ow = im2col(x, kh, kw, stride, pad)
    wmat = w.reshape(o, -1).astype(np.int64)
    out = cols.astype(np.int64) @ wmat.T         # (oh*ow, O)
    return out.T.reshape(o, oh, ow)


def dense_int(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    return x.astype(np.int64) @ w.astype(np.int64).T


def _bias(x: np.ndarray, n_bits: int) -> np.ndarray:
    """Signed -> order-preserving unsigned (flip sign bit)."""
    return (x.astype(np.int64) + (1 << (n_bits - 1))) & ((1 << n_bits) - 1)


def _check_range(flat: np.ndarray, n_bits: int, who: str) -> None:
    lim = 1 << (n_bits - 1)
    lo, hi = int(flat.min(initial=0)), int(flat.max(initial=0))
    if lo < -lim or hi >= lim:
        raise ValueError(
            f"{who}: activations [{lo}, {hi}] exceed {n_bits}-bit "
            f"two's-complement range [{-lim}, {lim - 1}]; widen n_bits "
            f"instead of silently clipping")


def relu_pum(dev: SimdramDevice, x: np.ndarray, n_bits: int = 16) -> np.ndarray:
    """ReLU as a dispatched queue of SIMDRAM ``relu`` bbops."""
    flat = x.reshape(-1).astype(np.int64)
    _check_range(flat, n_bits, "relu_pum")
    mask = (1 << n_bits) - 1

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(flat.size, n_parallel_units(dev)):
        shards.append((sl, qb.emit("relu", flat[sl] & mask, n_bits=n_bits)))
    out = gather(dev.dispatch(qb.queue), shards, flat.size)
    return out.reshape(x.shape)


def _pool_phases(x: np.ndarray):
    """(C,H,W) -> the four 2×2-phase planes, flattened, + pooled shape."""
    c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2]
    phases = [x[:, 0::2, 0::2], x[:, 0::2, 1::2],
              x[:, 1::2, 0::2], x[:, 1::2, 1::2]]
    return [p.reshape(-1).astype(np.int64) for p in phases], (c, h2, w2)


def maxpool2x2_pum(dev: SimdramDevice, x: np.ndarray, n_bits: int = 16) -> np.ndarray:
    """Signed 2×2 max-pool as one dispatched queue per shard: unsigned
    ``max`` tree over sign-bit-biased operands, un-biased by an in-queue
    signed subtraction."""
    _check_range(x.reshape(-1), n_bits, "maxpool2x2_pum")
    (a, b, cc, d), (c, h2, w2) = _pool_phases(x)
    n = a.size
    bias = 1 << (n_bits - 1)

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(n, n_parallel_units(dev)):
        m1 = qb.emit("max", _bias(a[sl], n_bits), _bias(b[sl], n_bits),
                     n_bits=n_bits)
        m2 = qb.emit("max", _bias(cc[sl], n_bits), _bias(d[sl], n_bits),
                     n_bits=n_bits)
        m = qb.emit("max", m1, m2, n_bits=n_bits)
        r = qb.emit("subtraction", m, np.full(a[sl].shape, bias, np.int64),
                    n_bits=n_bits, signed_out=True)
        shards.append((sl, r))
    out = gather(dev.dispatch(qb.queue), shards, n)
    return out.reshape(c, h2, w2)


def relu_maxpool2x2_pum(
    dev: SimdramDevice, x: np.ndarray, n_bits: int = 16
) -> np.ndarray:
    """Fused ReLU → 2×2 max-pool as ONE queue: four ``relu`` bbops (one
    per pool phase) feed an unsigned ``max`` tree directly — ReLU output
    is non-negative, so no sign-bit bias is needed and the whole fusion
    is a seven-instruction ``Ref`` chain per shard."""
    _check_range(x.reshape(-1), n_bits, "relu_maxpool2x2_pum")
    phases, (c, h2, w2) = _pool_phases(x)
    n = phases[0].size
    mask = (1 << n_bits) - 1

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(n, n_parallel_units(dev)):
        rs = [qb.emit("relu", p[sl] & mask, n_bits=n_bits) for p in phases]
        m1 = qb.emit("max", rs[0], rs[1], n_bits=n_bits)
        m2 = qb.emit("max", rs[2], rs[3], n_bits=n_bits)
        shards.append((sl, qb.emit("max", m1, m2, n_bits=n_bits)))
    out = gather(dev.dispatch(qb.queue), shards, n)
    return out.reshape(c, h2, w2)


def _pool_oracle(x: np.ndarray) -> np.ndarray:
    c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2]
    return np.maximum.reduce([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                              x[:, 1::2, 0::2], x[:, 1::2, 1::2]])


def run(
    in_ch: int = 2,
    img_hw: int = 8,
    out_ch: int = 3,
    fc_out: int = 5,
    n_bits: int = 16,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    seed: int = 0,
    torch_device: str = "cuda",
) -> Dict:
    """Small conv → fused ReLU+pool → dense → ReLU network, every
    elementwise stage a dispatched bbop queue, verified stage-by-stage
    against numpy."""
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, size=(in_ch, img_hw, img_hw)).astype(np.int64)
    wc = rng.integers(-4, 4, size=(out_ch, in_ch, 3, 3)).astype(np.int64)

    conv = conv2d_int(x, wc, pad=1)
    macs = conv.size * in_ch * 9
    LayerCost("conv", macs=macs, elements=conv.size).account_matmul(dev)

    pooled = relu_maxpool2x2_pum(dev, conv, n_bits=n_bits)
    want_pool = _pool_oracle(np.maximum(conv, 0))
    verify(np.array_equal(pooled, want_pool), "fused relu+pool mismatch",
           got=pooled.reshape(-1)[:8], want=want_pool.reshape(-1)[:8])

    wf = rng.integers(-4, 4, size=(fc_out, pooled.size)).astype(np.int64)
    fc = dense_int(pooled.reshape(1, -1), wf)
    macs_fc = fc.size * pooled.size
    LayerCost("fc", macs=macs_fc, elements=fc.size).account_matmul(dev)

    out = relu_pum(dev, fc, n_bits=n_bits)
    want_out = np.maximum(fc, 0)
    verify(np.array_equal(out, want_out), "final relu mismatch",
           got=out.reshape(-1), want=want_out.reshape(-1))

    return {"arch": "nn_layers", "macs": macs + macs_fc,
            "backend": dev.backend, "verified": True,
            "output": out.reshape(-1), **dev.totals()}
