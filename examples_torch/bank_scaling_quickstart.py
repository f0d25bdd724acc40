"""Quickstart: bank-level parallel execution (the paper's scaling axis).

The port's counterpart of ``examples/bank_scaling_quickstart.py``: a
16-subarray bank whose every fused wave is one K5 launch on the card,
one wide bbop split across the subarrays, a queue of bbops through the
round-robin dispatcher, and the modeled throughput-vs-subarray-count
curve.

Run:  PYTHONPATH=src python examples_torch/bank_scaling_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.bank import Bank, BbopInstr
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.isa import compile_op
from repro_torch.core.ops_library import get_op
from repro_torch.core.timing import DDR4, bank_throughput_gops
from repro_torch.kernels.build import resolve_device

MEASURED = ("wall_s", "pack_wall_s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}
    rng = np.random.default_rng(0)

    # ---- one wide bbop: lanes split across all 16 subarrays ---------------
    bank = Bank(n_subarrays=16, device=device)
    x = rng.integers(0, 256, size=50_000)
    y = rng.integers(0, 256, size=50_000)
    got = bank.bbop("addition", x, y, n_bits=8)
    want = get_op("addition", 8).oracle(
        x.astype(np.uint64), y.astype(np.uint64))[0]
    assert np.array_equal(got.astype(np.uint64) & 0xFF, want & 0xFF)
    print(f"bbop addition/8b on {x.size:,} lanes across "
          f"{bank.n_subarrays} subarrays: "
          f"{bank.stats.batches} concurrent replay(s), bit-exact ✓")
    out["results"]["bbop"] = np.asarray(got).astype(np.int64).tolist()
    out["modeled"]["bbop_batches"] = bank.stats.batches

    # ---- a queue of mixed bbops through the dispatcher ---------------------
    bank.reset_stats()
    queue = [
        BbopInstr(op, (rng.integers(0, 256, 4096),
                       rng.integers(0, 256, 4096)), 8)
        for op in ("addition", "subtraction", "min", "max") * 8
    ]
    results = bank.dispatch(queue)
    s = bank.stats
    print(f"dispatched {s.bbops} bbops in {s.batches} batches: "
          f"modeled wall {s.latency_s*1e6:.1f} µs, "
          f"{s.energy_nj/1e3:.1f} µJ, {s.throughput_gops:.3f} GOps/s "
          f"(engine lanes only)")
    print(f"programs per subarray (round-robin): "
          f"{s.subarray_programs.tolist()}")
    out["results"]["queue"] = [np.asarray(r).astype(np.int64).tolist()
                               for r in results]
    out["modeled"]["queue_stats"] = {
        k: v for k, v in s.as_dict().items() if k not in MEASURED}
    out["modeled"]["subarray_programs"] = s.subarray_programs.tolist()

    # ---- the paper's throughput-vs-bank-count curve ------------------------
    print("\nmodeled throughput, addition/8b (GOps/s):")
    _, up = compile_op("addition", 8)
    for n in (1, 2, 4, 8, 16):
        gops = bank_throughput_gops(up, DDR4, n_subarrays=n)
        print(f"  {n:2d} subarrays: {gops:8.1f}  "
              f"({'#' * int(gops / 25)})")
        out["modeled"][f"gops_{n}"] = gops
    print("\nfull sweep: python -m benchmarks.bank_scaling")

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
