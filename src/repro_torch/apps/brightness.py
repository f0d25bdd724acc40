"""Image brightness adjustment on SIMDRAM (paper §5 app kernel).

out = clamp(pixel + delta, 0, 255) per channel — a bulk add with
saturation (Gonzalez & Woods' brightness operator).  Each pixel shard is
one five-instruction ``Ref`` chain (add → underflow test → floor select
→ overflow test → ceiling select) drained through
:meth:`SimdramDevice.dispatch`, so the sum and its predicate bits
forward vertically between instructions on the fused backends.

10-bit two's-complement arithmetic covers any ``delta`` in
``[-255, 255]``: sums lie in ``[-255, 510]``, and a negative sum is
exactly one whose unsigned 10-bit encoding is ``>= 512`` (bit 9 set) —
so the clamp needs only unsigned relationals.  Deltas outside that
range raise ``ValueError`` (the seed silently mis-wrapped them).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.isa import SimdramDevice

from .runtime import (QueueBuilder, gather, n_parallel_units,
                      resolve_device, shard_slices, verify)


def run(
    h: int = 128,
    w: int = 128,
    delta: int = 40,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    seed: int = 0,
    torch_device: str = "cuda",
) -> Dict:
    if not -255 <= delta <= 255:
        raise ValueError(
            f"delta must be in [-255, 255] for 10-bit saturating add, "
            f"got {delta}")
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(3, h, w)).astype(np.int64)
    flat = img.reshape(-1)

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(flat.size, n_parallel_units(dev)):
        px = flat[sl]
        zeros = np.zeros(px.shape, np.int64)
        r_s = qb.emit("addition", px, np.full(px.shape, delta % 1024, np.int64),
                      n_bits=10)
        r_under = qb.emit("greater_equal", r_s,
                          np.full(px.shape, 512, np.int64), n_bits=10)
        r_floor = qb.emit("if_else", r_under, zeros, r_s, n_bits=10)
        r_over = qb.emit("greater", r_floor,
                         np.full(px.shape, 255, np.int64), n_bits=10)
        r_out = qb.emit("if_else", r_over,
                        np.full(px.shape, 255, np.int64), r_floor, n_bits=10)
        shards.append((sl, r_out))

    results = dev.dispatch(qb.queue)
    clipped = gather(results, shards, flat.size)

    want = np.clip(img + delta, 0, 255).reshape(-1)
    verify(np.array_equal(clipped, want), "brightness mismatch",
           got=clipped[:8], want=want[:8])

    return {"arch": "brightness", "pixels": int(flat.size),
            "backend": dev.backend, "verified": True, "output": clipped,
            **dev.totals()}
