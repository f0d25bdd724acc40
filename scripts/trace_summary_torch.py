#!/usr/bin/env python
"""Per-stage latency table from a Chrome trace-event JSON (PyTorch port).

The port's counterpart of ``scripts/trace_summary.py``, over
``repro_torch.core.telemetry.stage_summary``; it reads the traces either
package writes.

Reads a trace written by
:func:`repro_torch.core.telemetry.write_chrome_trace` (e.g.
``/tmp/simdram_trace.json`` from ``examples_torch/telemetry_quickstart.py``)
and prints one row per span name: how many times the stage ran, its
summed measured host wall time, its summed modeled DRAM-clock time, and
the modeled/measured ratio — the quickest way to see where a
dispatch actually spends time versus where the cost model says the DRAM
would.

Usage:
  python scripts/trace_summary_torch.py /tmp/simdram_trace.json
  python scripts/trace_summary_torch.py /tmp/simdram_trace.json --sort modeled
  python scripts/trace_summary_torch.py /tmp/simdram_trace.json --cat replay
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.core.telemetry import stage_summary  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(
        description="print a per-stage latency table from a telemetry "
                    "Chrome trace")
    p.add_argument("trace", help="Chrome trace-event JSON file")
    p.add_argument("--sort", choices=("wall", "modeled", "count"),
                   default="wall", help="sort column (default: wall)")
    p.add_argument("--cat", default=None,
                   help="only show stages in this category "
                        "(e.g. replay, pack, transfer, fault)")
    args = p.parse_args()

    with open(args.trace) as fh:
        trace = json.load(fh)
    rows = stage_summary(trace)
    if args.cat:
        rows = [r for r in rows if r["cat"] == args.cat]
    key = {"wall": "wall_us", "modeled": "modeled_us",
           "count": "count"}[args.sort]
    rows.sort(key=lambda r: -r[key])

    meta = trace.get("otherData", {})
    if meta:
        print(f"# roots={meta.get('n_roots', '?')} "
              f"incidents={meta.get('n_incidents', '?')}")
        for cat, total in sorted(
                meta.get("modeled_totals_s", {}).items()):
            print(f"# modeled[{cat}] = {total * 1e6:.3f} us")

    hdr = f"{'stage':<28} {'cat':<10} {'count':>6} " \
          f"{'wall_us':>12} {'modeled_us':>12} {'mod/wall':>9}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['stage']:<28} {r['cat']:<10} {r['count']:>6} "
              f"{r['wall_us']:>12.1f} {r['modeled_us']:>12.3f} "
              f"{r['modeled_over_wall']:>9.3g}")
    if not rows:
        print("(no matching spans)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
