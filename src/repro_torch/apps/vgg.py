"""VGG-13 / VGG-16 quantized inference on the SIMDRAM substrate (paper §5).

Convolution MACs are charged to the device as bit-serial mul+add
μPrograms (the paper's accounting); ReLU and max-pool stages execute as
*real* dispatched bbop queues on the selected backend.  The plan walker
looks one item ahead: a conv whose ReLU is immediately followed by
``'M'`` fuses both into one
:func:`~repro_torch.apps.nn_layers.relu_maxpool2x2_pum` ``Ref`` chain;
stand-alone stages use :func:`~repro_torch.apps.nn_layers.relu_pum` /
:func:`~repro_torch.apps.nn_layers.maxpool2x2_pum`.  Synthetic int8 weights;
every stage verifies against an integer numpy oracle with a raising
check.

``run(arch="vgg13"|"vgg16", n_layers=k, ...)`` truncates the plan to
its first ``k`` items (for fast cross-backend gating) and returns
command/latency/energy totals.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.isa import SimdramDevice

from .nn_layers import (LayerCost, _pool_oracle, conv2d_int, maxpool2x2_pum,
                        relu_maxpool2x2_pum, relu_pum)
from .runtime import resolve_device, verify

# (conv channel plan per block, 'M' = 2x2 maxpool) — standard VGG configs
VGG_PLANS = {
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
}


def run(
    arch: str = "vgg13",
    img_hw: int = 32,
    n_classes: int = 10,
    n_layers: int | None = None,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    seed: int = 0,
    elementwise_pum: bool = True,
    torch_device: str = "cuda",
) -> Dict:
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)
    plan = VGG_PLANS[arch]
    if n_layers is not None:
        plan = plan[:n_layers]

    x = rng.integers(-64, 64, size=(3, img_hw, img_hw)).astype(np.int64)
    c_in = 3
    total_macs = 0
    li = 0
    while li < len(plan):
        item = plan[li]
        if item == "M":
            ref = _pool_oracle(x)
            if elementwise_pum:
                x = maxpool2x2_pum(dev, x, n_bits=16)
                verify(np.array_equal(x, ref), f"{arch} maxpool L{li}")
            else:
                x = ref
            li += 1
            continue
        c_out = int(item)
        w = rng.integers(-8, 8, size=(c_out, c_in, 3, 3)).astype(np.int64)
        y = conv2d_int(x, w, stride=1, pad=1)
        macs = int(np.prod(y.shape)) * c_in * 9
        total_macs += macs
        LayerCost(f"conv{li}", macs, int(np.prod(y.shape))).account_matmul(dev, n_bits=8)
        # re-quantize activations to int16 range then ReLU (+pool) in PuM
        y = np.clip(y >> 6, -(1 << 15), (1 << 15) - 1)
        fuse_pool = li + 1 < len(plan) and plan[li + 1] == "M"
        if fuse_pool:
            ref = _pool_oracle(np.maximum(y, 0))
            if elementwise_pum:
                y = relu_maxpool2x2_pum(dev, y, n_bits=16)
                verify(np.array_equal(y, ref), f"{arch} relu+pool L{li}")
            else:
                y = ref
            li += 2
        else:
            ref = np.maximum(y, 0)
            if elementwise_pum:
                y = relu_pum(dev, y, n_bits=16)
                verify(np.array_equal(y, ref), f"{arch} relu L{li}")
            else:
                y = ref
            li += 1
        x = y
        c_in = c_out

    # classifier head (host-side, like the paper's CPU fallback)
    feat = x.reshape(-1)
    wfc = rng.integers(-8, 8, size=(n_classes, feat.shape[0])).astype(np.int64)
    logits = wfc @ feat
    return {
        "arch": arch,
        "macs": total_macs,
        "pred": int(np.argmax(logits)),
        "backend": dev.backend,
        "verified": True,
        "output": logits,
        **dev.totals(),
    }
