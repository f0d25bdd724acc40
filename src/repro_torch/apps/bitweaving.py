"""BitWeaving column scans on SIMDRAM (paper §5 app kernel).

BitWeaving (Li & Patel, SIGMOD'13) evaluates predicates over bit-packed
columns; its vertical (BitWeaving/V) layout is precisely SIMDRAM's
vertical layout, so a predicate scan is a single relational bbop over
all rows.  The three device-side scans (=, >, >=) over every row shard
go into ONE dispatch queue; the complements (!=, <, <=) derive
host-side as ``1 - x`` on the returned bit-vectors, exactly as a scan
engine would negate a result bit-vector.  All six selectivities verify
against numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.isa import SimdramDevice

from .runtime import (QueueBuilder, gather, n_parallel_units,
                      resolve_device, shard_slices, verify)


def run(
    n_rows: int = 65536,
    n_bits: int = 12,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    seed: int = 0,
    torch_device: str = "cuda",
) -> Dict:
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)
    col = rng.integers(0, 1 << n_bits, size=n_rows).astype(np.int64)
    c = int(rng.integers(0, 1 << n_bits))

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(n_rows, n_parallel_units(dev)):
        x = col[sl]
        cc = np.full(x.shape, c, np.int64)
        r_eq = qb.emit("equal", x, cc, n_bits=n_bits)
        r_gt = qb.emit("greater", x, cc, n_bits=n_bits)
        r_ge = qb.emit("greater_equal", x, cc, n_bits=n_bits)
        shards.append((sl, (r_eq, r_gt, r_ge)))

    results = dev.dispatch(qb.queue)
    eq = gather(results, [(sl, r) for sl, (r, _, _) in shards], n_rows)
    gt = gather(results, [(sl, r) for sl, (_, r, _) in shards], n_rows)
    ge = gather(results, [(sl, r) for sl, (_, _, r) in shards], n_rows)

    preds = {
        "eq": eq, "ne": 1 - eq, "gt": gt, "ge": ge, "lt": 1 - ge, "le": 1 - gt,
    }
    oracle = {
        "eq": col == c, "ne": col != c, "gt": col > c,
        "ge": col >= c, "lt": col < c, "le": col <= c,
    }
    for k in preds:
        verify(np.array_equal(preds[k].astype(bool), oracle[k]),
               f"bitweaving {k} scan mismatch")

    return {
        "arch": "bitweaving", "rows": n_rows, "n_bits": n_bits,
        "sel_eq": int(eq.sum()), "sel_gt": int(gt.sum()),
        "backend": dev.backend, "verified": True,
        "output": np.concatenate([eq, gt, ge]), **dev.totals(),
    }
