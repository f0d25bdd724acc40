"""k-nearest-neighbours on SIMDRAM (paper §5 app kernel).

Distance computation is the bulk-parallel part: L1 distance between the
query and every reference point, built as one subtract→abs→accumulate
``Ref`` chain per feature (all N reference points as SIMD lanes) and
drained through :meth:`SimdramDevice.dispatch` — the chain's
intermediate bit-planes forward vertically on the fused backends.  Lanes
shard into one independent chain per compute unit so the chip/channel
partitioners can spread the work.  Top-k selection happens host-side on
the N distances (tiny), matching the paper's split.

Width/signedness plumbing (the seed-era audit): differences are
computed at ``n_bits + 1`` with ``signed_out=True`` — any pair drawn
from one ``2**n_bits``-wide window (unsigned ``[0, 2**n_bits)`` or
signed ``[-2**(n_bits-1), 2**(n_bits-1))``) differs by at most
``2**n_bits - 1``, which an (n+1)-bit two's-complement word represents
exactly, including both ``±2**(n_bits-1)`` edges.  ``abs`` then yields
a NON-negative (n+1)-bit value, so it is emitted unsigned
(``signed_out=False``): forwarding into the wider accumulator must
zero-extend, and the accumulator width ``n_bits +
ceil(log2(n_features)) + 1`` holds the worst-case sum exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.isa import SimdramDevice

from .runtime import (QueueBuilder, gather, n_parallel_units,
                      resolve_device, shard_slices, verify)


def l1_distance(dev: SimdramDevice, refs: np.ndarray, query: np.ndarray,
                n_bits: int) -> np.ndarray:
    """L1 distances from ``query`` to every row of ``refs`` via one
    dispatched bbop queue.  All values must lie in one ``2**n_bits``-wide
    window (see module docstring) for the (n+1)-bit differences to be
    exact."""
    n_points, n_features = refs.shape
    diff_bits = n_bits + 1
    acc_bits = n_bits + max(int(np.ceil(np.log2(max(n_features, 1)))), 0) + 1
    dmask = (1 << diff_bits) - 1

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(n_points, n_parallel_units(dev)):
        acc = None
        for f in range(n_features):
            col = refs[sl, f].astype(np.int64) & dmask
            q = np.full(col.shape, int(query[f]) & dmask, np.int64)
            d = qb.emit("subtraction", col, q, n_bits=diff_bits,
                        signed_out=True)
            a = qb.emit("abs", d, n_bits=diff_bits)
            prev = acc if acc is not None else np.zeros(col.shape, np.int64)
            acc = qb.emit("addition", prev, a, n_bits=acc_bits)
        shards.append((sl, acc))
    results = dev.dispatch(qb.queue)
    return gather(results, shards, n_points)


def run(
    n_points: int = 4096,
    n_features: int = 16,
    k: int = 5,
    n_bits: int = 8,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    signed: bool = False,
    seed: int = 0,
    torch_device: str = "cuda",
) -> Dict:
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)
    if signed:
        lo, hi = -(1 << (n_bits - 1)), 1 << (n_bits - 1)
    else:
        lo, hi = 0, 1 << n_bits
    refs = rng.integers(lo, hi, size=(n_points, n_features)).astype(np.int64)
    labels = rng.integers(0, 4, size=n_points)
    query = rng.integers(lo, hi, size=(n_features,)).astype(np.int64)

    dist = l1_distance(dev, refs, query, n_bits)

    want = np.abs(refs - query[None, :]).sum(axis=1)
    verify(np.array_equal(dist, want), "kNN L1 distance mismatch",
           got=dist[:8], want=want[:8])

    nearest = np.argsort(dist, kind="stable")[:k]
    pred = int(np.bincount(labels[nearest]).argmax())
    return {"arch": "knn", "n_points": n_points, "pred": pred,
            "backend": dev.backend, "verified": True, "output": dist,
            **dev.totals()}
