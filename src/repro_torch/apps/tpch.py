"""TPC-H-style predicate scan + aggregation on SIMDRAM (paper §5).

Models the selection/aggregation core of TPC-H Q6:

  SELECT SUM(extendedprice * discount) FROM lineitem
  WHERE shipdate in range AND discount BETWEEN lo AND hi AND quantity < q

The whole query body is one ``Ref`` chain per row shard — five
relational bbops, a two-level ``and_red`` conjunction, the PuM multiply
and the predicating ``if_else`` — drained through
:meth:`SimdramDevice.dispatch` so the predicate bit-vectors forward
vertically between instructions on the fused backends.  The paper's
``<``/``<=`` comparisons against constants lower onto the unsigned
``greater``/``greater_equal`` primitives with the constant as the LEFT
operand (``x < c  ≡  c > x``), keeping every predicate in-queue.  Only
the final SUM of masked revenues happens host-side (the paper
aggregates partial sums on the CPU too).  Verified against a numpy
query oracle.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.isa import SimdramDevice

from .runtime import (QueueBuilder, gather, n_parallel_units,
                      resolve_device, shard_slices, verify)


def run(
    n_rows: int = 8192,
    device: SimdramDevice | None = None,
    backend: str = "bitplane",
    seed: int = 0,
    torch_device: str = "cuda",
) -> Dict:
    dev = resolve_device(device, backend, torch_device=torch_device)
    rng = np.random.default_rng(seed)

    shipdate = rng.integers(0, 2556, size=n_rows).astype(np.int64)      # days
    quantity = rng.integers(1, 51, size=n_rows).astype(np.int64)
    discount = rng.integers(0, 11, size=n_rows).astype(np.int64)        # percent
    price = rng.integers(100, 10000, size=n_rows).astype(np.int64)

    d_lo, d_hi, q_lt = 4, 6, 24
    t_lo, t_hi = 365, 730

    qb = QueueBuilder()
    shards = []
    for sl in shard_slices(n_rows, n_parallel_units(dev)):
        sd, qt, dc, pr = shipdate[sl], quantity[sl], discount[sl], price[sl]

        def full(c, like):
            return np.full(like.shape, c, np.int64)

        r_tlo = qb.emit("greater_equal", sd, full(t_lo, sd), n_bits=12)
        r_thi = qb.emit("greater", full(t_hi, sd), sd, n_bits=12)       # sd < t_hi
        r_dlo = qb.emit("greater_equal", dc, full(d_lo, dc), n_bits=4)
        r_dhi = qb.emit("greater_equal", full(d_hi, dc), dc, n_bits=4)  # dc <= d_hi
        r_q = qb.emit("greater", full(q_lt, qt), qt, n_bits=6)          # qt < q_lt
        r_a = qb.emit("and_red", r_tlo, r_thi, r_dlo, r_dhi, n_bits=1)
        ones = np.ones(sd.shape, np.int64)
        r_sel = qb.emit("and_red", r_a, r_q, ones, ones, n_bits=1)
        r_mul = qb.emit("multiplication", pr, dc, n_bits=14)
        r_rev = qb.emit("if_else", r_sel, r_mul,
                        np.zeros(sd.shape, np.int64), n_bits=28)
        shards.append((sl, (r_sel, r_rev)))

    results = dev.dispatch(qb.queue)
    sel = gather(results, [(sl, rs) for sl, (rs, _) in shards], n_rows)
    masked = gather(results, [(sl, rr) for sl, (_, rr) in shards], n_rows)
    revenue = int(masked.sum())

    want_sel = ((shipdate >= t_lo) & (shipdate < t_hi)
                & (discount >= d_lo) & (discount <= d_hi) & (quantity < q_lt))
    want = int((price * discount)[want_sel].sum())
    verify(revenue == want, "TPC-H Q6 revenue mismatch",
           got=revenue, want=want)
    verify(np.array_equal(sel.astype(bool), want_sel),
           "TPC-H Q6 selection-vector mismatch")

    return {"arch": "tpch_q6", "rows": n_rows, "selected": int(sel.sum()),
            "revenue": revenue, "backend": dev.backend, "verified": True,
            "output": masked, **dev.totals()}
