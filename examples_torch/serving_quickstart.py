"""Multi-tenant serving front-end: admit, coalesce, degrade — end to end.

The port's counterpart of ``examples/serving_quickstart.py``, whose
module-scope walk-through is ``main()`` here.

Run:  PYTHONPATH=src python examples_torch/serving_quickstart.py [--device cpu]

Walks the whole request-stream layer over a ``SimdramChannel`` whose
super-rounds are K5 launches on the card (K6 for the faulty channel):

  - three tenants submit mixed-op requests with deadlines and
    priorities and get back ``Ticket`` futures; one ``pump()`` window
    coalesces compatible ``(op, width)`` requests across tenants into
    ONE shared wave and fans the results back out bit-exactly;
  - a bounded admission queue rejects overflow with a typed
    ``AdmissionRejected`` (carrying queue depth and capacity);
  - an impossible deadline is cancelled at a replay boundary via the
    engines' ``cancel=`` hook and surfaces as ``DeadlineExceeded`` —
    never a silently late answer;
  - a persistent dead subarray (zero redispatch budget) trips the
    per-tenant circuit breaker: failed and shed requests are answered
    from the host oracle (bit-identical, just not DRAM-priced), and
    after the cooldown the half-open probe lands back on DRAM because
    the engine blacklisted the dead unit — closing the breaker.

Everything runs on the *modeled* DRAM clock (``fe.now_s``), so this
script is deterministic end to end.  Windows are pumped on the calling
thread (``drain()``); no worker thread is started.
"""

import argparse

import numpy as np

from repro_torch.core.channel import SimdramChannel
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.fault import FaultModel
from repro_torch.kernels.build import resolve_device
from repro_torch.serving import (AdmissionRejected, DeadlineExceeded,
                                 ServingFrontend)
from repro_torch.train.serve import bbop_host_oracle

LANES = 64


def _value(t):
    return np.asarray(t.result()).reshape(-1).astype(np.int64).tolist()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}
    rng = np.random.default_rng(0)
    arr = lambda: rng.integers(0, 256, LANES).astype(np.int64)

    # -- 1. coalesced multi-tenant window -----------------------------------
    fe = ServingFrontend(SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                                        device=device))
    ops = [("alice", "addition"), ("bob", "addition"), ("carol", "min"),
           ("alice", "multiplication"), ("bob", "relu")]
    tickets = []
    for tenant, op in ops:
        operands = (arr(),) if op == "relu" else (arr(), arr())
        tickets.append((fe.submit(tenant, op, operands, 8,
                                  deadline_s=fe.now_s + 1.0), op, operands))
    fe.drain()
    exact = all(np.array_equal(np.asarray(t.result()).reshape(-1),
                               np.asarray(bbop_host_oracle(op, 8, operands))
                               .reshape(-1))
                for t, op, operands in tickets)
    print(f"{len(ops)} requests from 3 tenants coalesced into "
          f"{fe.stats.coalesced_instrs} instructions over {fe.stats.waves} "
          f"wave(s); all bit-exact vs host oracle: {exact}")
    print(f"modeled clock now at {fe.now_s * 1e6:.1f} us\n")
    out["results"]["window"] = [_value(t) for t, _, _ in tickets]
    out["modeled"]["window"] = [exact, fe.stats.coalesced_instrs,
                                fe.stats.waves, fe.now_s]

    # -- 2. bounded admission -----------------------------------------------
    small = ServingFrontend(SimdramChannel(n_chips=1, n_banks=2,
                                           n_subarrays=2, device=device),
                            max_queue_depth=2)
    admitted = [small.submit("alice", "addition", (arr(), arr()), 8),
                small.submit("bob", "addition", (arr(), arr()), 8)]
    try:
        small.submit("carol", "addition", (arr(), arr()), 8)
    except AdmissionRejected as e:
        print(f"admission overflow: {e} "
              f"(queue_depth={e.queue_depth}, capacity={e.capacity})")
        out["modeled"]["rejected"] = [str(e), e.queue_depth, e.capacity]
    small.drain()
    out["results"]["admitted"] = [_value(t) for t in admitted]

    # -- 3. deadlines are typed, never silent -------------------------------
    t = fe.submit("alice", "multiplication", (arr(), arr()), 16,
                  deadline_s=fe.now_s + 1e-9)      # < one wave of DRAM time
    fe.drain()
    try:
        t.result()
    except DeadlineExceeded as e:
        print(f"impossible deadline: {e}")
        out["modeled"]["deadline"] = str(e)
    print(f"cancelled waves: {fe.stats.cancelled_waves}, "
          f"deadline misses: {fe.stats.deadline_missed}\n")
    out["modeled"]["frontend"] = fe.stats.as_dict()

    # -- 4. breaker: trip -> shed -> half-open -> recover -------------------
    # seed=0 kills exactly one subarray on this (1 chip, 2 banks, 2
    # subarrays) channel; four distinct ops force four wave slots so the
    # first window deterministically lands on it
    model = FaultModel(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                       max_redispatches=0, seed=0)
    fb = ServingFrontend(SimdramChannel(n_chips=1, n_banks=2, n_subarrays=2,
                                        fault=model, device=device),
                         max_retries=0, breaker_threshold=1,
                         breaker_cooldown_s=1e-5)
    window = lambda: [fb.submit("alice", op, (arr(), arr()), 8)
                      for op in ("addition", "subtraction", "min", "max")]
    first = window(); fb.drain()
    print(f"dead subarray exhausted the fault budget -> breaker "
          f"trips={fb.stats.breaker_trips}, answered via host oracle: "
          f"{all(t.via_host for t in first)}")
    shed = window(); fb.drain()
    print(f"while OPEN, requests shed straight to host "
          f"(fallbacks={fb.stats.host_fallbacks}, no DRAM dispatched)")
    fb.now_s += 10 * fb.breaker_cooldown_s         # cooldown elapses
    probe = window(); fb.drain()
    print(f"half-open probe repacked around the blacklisted unit -> back "
          f"on DRAM: {all(not t.via_host for t in probe)}, "
          f"recoveries={fb.stats.breaker_recoveries}")
    print(f"\nfrontend stats: {fb.stats.as_dict()}")
    out["results"]["breaker"] = [[_value(t) for t in w]
                                 for w in (first, shed, probe)]
    out["modeled"]["breaker"] = {
        "via_host": [[t.via_host for t in w] for w in (first, shed, probe)],
        "stats": fb.stats.as_dict(), "now_s": fb.now_s}

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
