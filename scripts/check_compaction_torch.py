"""Compaction gate of the PyTorch port: activations ≤ uncompacted + bit-exact.

The port's counterpart of ``scripts/check_compaction.py``: the same sweep,
lanes and seed through ``repro_torch``'s ``compile_op``, ``compact`` and
``subarray.run_op``, and the same summary line.  Pure numpy and Python:
it needs no card.

Validates the Step-2.5 μProgram compaction pass over the 16-op library:
for every (op, width, style) in the sweep, the compacted program must

  1. never activate more rows than the allocator's raw output
     (``n_activations`` is the paper's first-order cost metric);
  2. be bit-exact against the uncompacted program on random operands,
     executed through the faithful DRAM subarray simulator;
  3. keep the RowHammer activation streak within
     ``max(allocator's streak, ROWHAMMER_STREAK_BOUND)`` (paper §4).

Default sweep: all 16 ops × {8, 16} bits × {MIG, AIG}, plus 32-bit for
every op except multiplication/division (their 32-bit allocator runs
take minutes — ``--full`` includes them; the cheap-op 32-bit cross
still exercises the widest datapaths every CI run).

    PYTHONPATH=src python scripts/check_compaction_torch.py [--full]
"""
import argparse
import sys
import time

import numpy as np

from repro_torch.core.isa import compile_op
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.subarray import run_op
from repro_torch.core.synthesis import compact
from repro_torch.core.uprogram import ROWHAMMER_STREAK_BOUND, max_activation_streak

SLOW_32B = ("multiplication", "division")


def sweep(full: bool = False):
    for style in ("mig", "aig"):
        for name in ALL_OPS:
            for n_bits in (8, 16, 32):
                if n_bits == 32 and not full and name in SLOW_32B:
                    continue
                yield name, n_bits, style


def main(full: bool = False, lanes: int = 96, seed: int = 11) -> int:
    rng = np.random.default_rng(seed)
    before = after = n_cases = 0
    t0 = time.time()
    for name, n_bits, style in sweep(full):
        spec = get_op(name, n_bits)
        # compile the allocator output once, compact it directly —
        # identical to compile_op(compact=True) without re-allocating
        _, up_u = compile_op(name, n_bits, style, compact=False)
        up_c, report = compact(up_u)
        assert up_c.n_activations <= up_u.n_activations, \
            f"{name}/{n_bits}/{style}: compaction ADDED activations"
        assert (max_activation_streak(up_c.commands)
                <= max(max_activation_streak(up_u.commands),
                       ROWHAMMER_STREAK_BOUND)), \
            f"{name}/{n_bits}/{style}: RowHammer streak worsened"
        ops_vals = [rng.integers(0, 1 << w, size=lanes).astype(np.uint64)
                    for w in spec.operand_bits]
        cols = lanes + (-lanes) % 32
        want = run_op(up_u, spec.out_bits, ops_vals, n_columns=cols)
        got = run_op(up_c, spec.out_bits, ops_vals, n_columns=cols)
        for gi, (g, e) in enumerate(zip(got, want)):
            assert np.array_equal(g, e), \
                f"{name}/{n_bits}/{style}: output {gi} DIVERGES"
        before += up_u.n_activations
        after += up_c.n_activations
        n_cases += 1
    pct = 100.0 * (1.0 - after / max(before, 1))
    print(f"COMPACTION OK: {n_cases} cases bit-exact, "
          f"{before} -> {after} activations ({pct:.1f}% fewer), "
          f"{time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="include multiplication/division at 32 bits "
                        "(slow: minutes of allocator time)")
    args = p.parse_args()
    sys.exit(main(full=args.full))
