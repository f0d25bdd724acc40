"""K3's host lowering of every op the repo compiles, on the CPU.

    PYTHONPATH=src python experiments/circuit_lowering.py [--json OUT.json]

For each of the 16 ops at 8, 16 and 32 bits, as the synthesized MIG
circuit and as the raw AIG description, it lowers the circuit with
``lower_circuit`` and prints: gates, levels, the slots of the program
with its gates as soon as possible (``asap``) and as ``_schedule``
places them (``sched``), the shared memory a block of the chosen program
needs against ``MAX_SHARED_BYTES``, and the wall time of one
``lower_circuit`` call on this host (the first lowering of a circuit;
``slot_program`` caches it).  The summary names the circuits on which
the as-soon-as-possible program wins, and the largest slot count and
shared-memory size over all of them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core import bitplane
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.kernels import bitplane_ops


def _circuit(op: str, n_bits: int, style: str):
    if style == "mig":
        _, circ, ids = bitplane._compiled_op(op, n_bits)
    else:
        circ, ids = get_op(op, n_bits).build("aig")
    return circ, ids


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args()
    rows = []
    print(f"{'op':15s} {'bits':>4s} style {'gates':>5s} {'levels':>6s} "
          f"{'asap':>5s} {'sched':>5s} {'shared B':>8s} {'lower ms':>9s}")
    for n_bits in (8, 16, 32):
        for style in ("mig", "aig"):
            for op in ALL_OPS:
                circ, ids = _circuit(op, n_bits, style)
                t0 = time.perf_counter()
                prog = bitplane_ops.lower_circuit(circ, ids)
                ms = (time.perf_counter() - t0) * 1e3
                asap, sched = (c.n_slots for c in
                               bitplane_ops._candidates(circ, ids))
                row = dict(op=op, n_bits=n_bits, style=style,
                           gates=prog.n_gates, levels=prog.n_levels,
                           asap_slots=asap, sched_slots=sched,
                           slots=prog.n_slots,
                           shared_bytes=prog.shared_bytes, lower_ms=ms)
                rows.append(row)
                print(f"{op:15s} {n_bits:4d} {style:5s} {prog.n_gates:5d} "
                      f"{prog.n_levels:6d} {asap:5d} {sched:5d} "
                      f"{prog.shared_bytes:8d} {ms:9.3f}", flush=True)
    wins = [f"{r['op']}/{r['n_bits']}/{r['style']}" for r in rows
            if r["asap_slots"] < r["sched_slots"]]
    big = max(rows, key=lambda r: r["shared_bytes"])
    slow = max(rows, key=lambda r: r["lower_ms"])
    summary = dict(
        asap_wins=wins,
        sched_wins=sum(r["sched_slots"] < r["asap_slots"] for r in rows),
        ties=sum(r["sched_slots"] == r["asap_slots"] for r in rows),
        max_slots=max(r["slots"] for r in rows),
        max_shared_bytes=big["shared_bytes"],
        max_shared_of=f"{big['op']}/{big['n_bits']}/{big['style']}",
        limit_bytes=bitplane_ops.MAX_SHARED_BYTES,
        max_lower_ms=slow["lower_ms"],
        max_lower_of=f"{slow['op']}/{slow['n_bits']}/{slow['style']}",
        total_lower_ms=sum(r["lower_ms"] for r in rows))
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0 if big["shared_bytes"] <= bitplane_ops.MAX_SHARED_BYTES else 1


if __name__ == "__main__":
    sys.exit(main())
