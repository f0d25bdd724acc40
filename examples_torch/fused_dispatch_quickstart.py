"""Fused heterogeneous dispatch + vertical operand forwarding, end to end.

The port's counterpart of ``examples/fused_dispatch_quickstart.py``,
whose module-scope walk-through is ``main()`` here.

Run:  PYTHONPATH=src python examples_torch/fused_dispatch_quickstart.py [--device cpu]

Builds one mixed-op queue (different ops, widths, signedness) plus a
producer→consumer chain, drains it through the fused dispatcher, and
prints the stats deltas versus the grouped baseline:

  - the fused path packs up to ``n_subarrays`` DIFFERENT command tables
    into one (n_subarrays, n_cmds, 13) stack and replays them in a
    single K5 launch — replay count drops from one per (op, width,
    signedness) group to one per wave;
  - ``Ref`` operands keep intermediates vertical: the producer's result
    bit-planes are copied straight into the consumer's operand rows,
    so the v2h→h2v transposition round trip disappears (stats price the
    saving via repro_torch.core.costmodel.forwarding_saving_s);
  - ``keep_vertical=True`` returns a ``VerticalOperand`` (bit-planes),
    the form you would feed the next queue; its values come back
    through K2.
"""

import argparse

import numpy as np

from repro_torch.core.bank import Bank, BbopInstr, Ref, VerticalOperand
from repro_torch.core.control_unit import kernel_counts
from repro_torch.kernels.build import resolve_device

N_SUB, LANES = 4, 4096
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

    def rand(bits, n=LANES):
        return rng.integers(0, 1 << bits, n).astype(np.uint64)

    # -- a heterogeneous queue: 8 distinct (op, width) groups ---------------
    queue = []
    for n_bits in (8, 16):
        x, y = rand(n_bits), rand(n_bits)
        queue += [
            BbopInstr("addition", (x, y), n_bits),
            BbopInstr("multiplication", (x, y), n_bits),
            BbopInstr("greater", (x, y), n_bits),
            BbopInstr("and_red", (x, y, rand(n_bits), rand(n_bits)), n_bits),
        ]

    # -- plus a chain whose intermediates never leave the vertical layout ---
    a, b = rand(8), rand(8)
    c = rand(16)
    base = len(queue)
    queue += [
        BbopInstr("multiplication", (a, b), 8),              # 16-bit product
        BbopInstr("addition", (Ref(base), c), 16),           # forwarded planes
        BbopInstr("relu", (Ref(base + 1),), 16, keep_vertical=True),
    ]

    for label, fuse in (("fused", True), ("grouped", False)):
        bank = Bank(n_subarrays=N_SUB, fuse=fuse, device=device)
        results = bank.dispatch(queue)
        s = bank.stats.as_dict()
        print(f"\n== {label} dispatch ==")
        print(f"  bbops={s['bbops']}  interpreter replays={s['batches']} "
              f"(fused waves: {s['fused_batches']})")
        print(f"  modeled latency: {s['latency_s'] * 1e6:9.1f} us"
              f"   energy: {s['energy_nj'] / 1e3:8.1f} uJ")
        print(f"  transpositions skipped: {s['transpositions_skipped']}"
              f"  (saving {s['transpose_s_saved'] * 1e9:.1f} ns of modeled"
              " transpose traffic)")
        out["modeled"][label] = {k: v for k, v in s.items()
                                 if k not in MEASURED}
        out["results"][label] = [
            (r.to_values() if isinstance(r, VerticalOperand)
             else np.asarray(r)).astype(np.int64).tolist()
            for r in results]
        if fuse:
            fused_results, fused_stats = results, s

    # the two paths are bit-exact — compare the chain's final output
    tail = fused_results[-1]
    assert isinstance(tail, VerticalOperand)     # keep_vertical => bit-planes
    want = (a * b + c) & 0xFFFF
    want = np.where(want >= 1 << 15, 0, want)    # relu on signed 16-bit
    np.testing.assert_array_equal(tail.to_values() & 0xFFFF, want)
    assert out["results"]["fused"] == out["results"]["grouped"]
    print("\nchain result (vertical, first 8 lanes):",
          tail.to_values()[:8].tolist())
    print("oracle agrees; fused path used "
          f"{fused_stats['batches']} replays for {fused_stats['bbops']} bbops.")

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
