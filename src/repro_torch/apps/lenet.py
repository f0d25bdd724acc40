"""LeNet-5 quantized inference on SIMDRAM (paper §5 app kernel).

Conv/fc MACs are charged analytically (bit-serial mul+add μPrograms);
every elementwise stage runs as a dispatched bbop queue — each conv
block's ReLU and 2×2 max-pool fuse into ONE
:func:`~repro_torch.apps.nn_layers.relu_maxpool2x2_pum` ``Ref`` chain, fc
ReLUs go through :func:`~repro_torch.apps.nn_layers.relu_pum` — so the whole
network exercises the selected backend ladder rung.  Each stage
verifies against a numpy oracle with a raising check.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.isa import SimdramDevice

from .nn_layers import (LayerCost, _pool_oracle, conv2d_int, dense_int,
                        relu_maxpool2x2_pum, relu_pum)
from .runtime import resolve_device, verify


def run(device: SimdramDevice | None = None,
        backend: str = "bitplane",
        seed: int = 0,
        elementwise_pum: bool = True,
        conv_channels: Tuple[int, ...] = (6, 16),
        fc_dims: Tuple[int, ...] = (120, 84, 10),
        torch_device: str = "cuda") -> Dict:
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)

    x = rng.integers(0, 64, size=(1, 28, 28)).astype(np.int64)
    total_macs = 0

    def conv_block(x, c_out, k, pad):
        nonlocal total_macs
        c_in = x.shape[0]
        w = rng.integers(-8, 8, size=(c_out, c_in, k, k)).astype(np.int64)
        y = conv2d_int(x, w, pad=pad)
        macs = int(np.prod(y.shape)) * c_in * k * k
        total_macs += macs
        LayerCost("conv", macs, int(np.prod(y.shape))).account_matmul(dev, 8)
        y = np.clip(y >> 4, -(1 << 15), (1 << 15) - 1)   # re-quantize to int16
        ref = _pool_oracle(np.maximum(y, 0))
        if not elementwise_pum:
            return ref
        out = relu_maxpool2x2_pum(dev, y, 16)
        verify(np.array_equal(out, ref), "lenet conv-block relu+pool mismatch")
        return out

    x = conv_block(x, conv_channels[0], 5, pad=2)     # 6×14×14
    x = conv_block(x, conv_channels[1], 5, pad=0)     # 16×5×5
    feat = x.reshape(-1)

    for i, width in enumerate(fc_dims):
        w = rng.integers(-8, 8, size=(width, feat.shape[0])).astype(np.int64)
        total_macs += width * feat.shape[0]
        LayerCost("fc", width * feat.shape[0], width).account_matmul(dev, 8)
        feat = dense_int(feat, w)
        feat = np.clip(feat >> 4, -(1 << 15), (1 << 15) - 1)
        if i != len(fc_dims) - 1:
            ref = np.maximum(feat, 0)
            if elementwise_pum:
                feat = relu_pum(dev, feat, 16)
                verify(np.array_equal(feat, ref), "lenet fc relu mismatch")
            else:
                feat = ref

    return {"arch": "lenet5", "macs": total_macs, "pred": int(np.argmax(feat)),
            "backend": dev.backend, "verified": True, "output": feat,
            **dev.totals()}
