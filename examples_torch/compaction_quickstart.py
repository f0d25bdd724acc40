"""μProgram compaction + compile-once replay, in five minutes.

The port's counterpart of ``examples/compaction_quickstart.py``, whose
module-scope walk-through is ``main()`` here.  The replay compilation
pipeline, bottom to top:

  1. **Step-2.5 compaction** — a removal-only peephole over the
     allocator's AAP/AP stream (dead-row-write elimination, RowClone
     chain collapsing, NOP squeezing).  ``n_activations`` is the
     paper's latency/energy currency, so every removed command is
     modeled time *and* a shorter replay for K5.
  2. **Device-resident table cache** — encoded+padded command tables
     are memoized per wave composition; a repeated dispatch re-encodes
     nothing and builds no kernel: the same K5 binary replays every
     program, because programs are data.
  3. **Cross-stage wave reordering** — ``Bank(packing="reorder")``
     (the default) hoists dataflow-independent work past slow
     producers, prioritized by critical-path cost.

    PYTHONPATH=src python examples_torch/compaction_quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.bank import Bank, BbopInstr, Ref
from repro_torch.core.control_unit import TABLE_CACHE, kernel_counts
from repro_torch.core.isa import compile_op
from repro_torch.core.synthesis import compact
from repro_torch.kernels.build import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}

    # -- 1. compaction: before/after stats -------------------------------
    print("=== μProgram compaction (Step 2.5) ===")
    for op in ("subtraction", "xor_red", "equal", "relu"):
        spec, raw = compile_op(op, 8, "mig", compact=False)
        small, report = compact(raw)
        print(f"{op:12s} raw {raw.stats()}")
        print(f"{'':12s} compacted {small.stats()}  "
              f"(-{report.removed_activations} activations, "
              f"{report.reduction:.1%})")
        out["modeled"][op] = [raw.stats(), small.stats(),
                              report.removed_activations, report.reduction]

    # -- 2. compile-once replay: pack time + rebuild counters ------------
    print("\n=== cached replay compilation ===")
    rng = np.random.default_rng(0)
    lanes = 4096

    def queue():
        x, y = (rng.integers(0, 256, lanes).astype(np.uint64)
                for _ in range(2))
        z = rng.integers(0, 1 << 16, lanes).astype(np.uint64)
        return [
            BbopInstr("multiplication", (x, y), 8),
            BbopInstr("addition", (Ref(0), z), 16),
            BbopInstr("greater", (x, y), 8),
            BbopInstr("relu", (Ref(1),), 16, keep_vertical=True),
        ]

    bank = Bank(n_subarrays=4, device=device)
    bank.dispatch(queue())                 # cold: fills the table cache
    for label in ("second", "third"):
        bank.reset_stats()
        k0, c0 = kernel_counts(), TABLE_CACHE.stats()
        t_wall = time.perf_counter()
        results = bank.dispatch(queue())
        wall_us = (time.perf_counter() - t_wall) * 1e6
        k1, c1 = kernel_counts(), TABLE_CACHE.stats()
        # the reference counts new XLA traces here; the port has no
        # tracing compiler: it counts kernel builds (nvcc runs, zero once
        # built) and the K5 launches the dispatch made (zero on the CPU,
        # which runs the plain replay)
        builds = sum(k1["builds"].values()) - sum(k0["builds"].values())
        k5 = k1["launches"]["replay"] - k0["launches"]["replay"]
        print(f"{label} dispatch: wall {wall_us:7.0f}us  "
              f"pack {bank.stats.pack_wall_s * 1e6:6.0f}us  "
              f"new builds {builds}  K5 launches +{k5}  "
              f"table-cache hits +{c1['hits'] - c0['hits']} "
              f"misses +{c1['misses'] - c0['misses']}")
        out["modeled"][label] = [builds, c1["hits"] - c0["hits"],
                                 c1["misses"] - c0["misses"],
                                 bank.stats.latency_s]
        out["results"][label] = [
            (r.to_values() if hasattr(r, "to_values") else np.asarray(r))
            .astype(np.int64).tolist() for r in results]

    # -- 3. cross-stage reordering ---------------------------------------
    print("\n=== cross-stage wave reordering ===")
    for packing in ("reorder", "ffd", "greedy"):
        b = Bank(n_subarrays=2, packing=packing, device=device)
        # one slow chain (mul -> add) + independent cheap ops: the
        # reorderer fills the chain's slack with ready work from other
        # stages
        x, y = (rng.integers(0, 256, 64).astype(np.uint64) for _ in range(2))
        q = [
            BbopInstr("multiplication", (x, y), 8),
            BbopInstr("addition", (Ref(0), x), 16),
            BbopInstr("greater", (x, y), 8),
            BbopInstr("min", (x, y), 8),
            BbopInstr("max", (x, y), 8),
        ]
        results = b.dispatch(q)
        print(f"packing={packing:8s} replays={b.stats.batches}  "
              f"modeled {b.stats.latency_s * 1e6:.1f}us")
        out["modeled"][packing] = [b.stats.batches, b.stats.latency_s]
        out["results"][packing] = [np.asarray(r).astype(np.int64).tolist()
                                   for r in results]

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
