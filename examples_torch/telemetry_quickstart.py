"""Ladder-wide telemetry: dual-clock spans, Perfetto export, post-mortem.

The port's counterpart of ``examples/telemetry_quickstart.py``, whose
module-scope walk-through is ``main()`` here.  Every stage of a dispatch
— validation, wave/round/super-round packing, table-cache lookup,
replay, transpose, transfer, unpack, fault handling — records TWO
clocks into one nested span tree:

  measured   host wall seconds this Python process actually spent
  modeled    DRAM-clock seconds from timing.py / costmodel.py, charged
             at the exact sites the Stats dataclasses accrue them

so the modeled clock reconciles with ``ChannelStats`` bit-for-bit, and
the measured clock shows where the *host* burns time (packing, the
kernels' launches).  On the card each ``*.replay`` span also carries
``device_s``, its K5/K6 launches timed with CUDA events.  Tracing is
opt-in and strictly free when off — ``obs.active_tracer()`` returns
``None`` and every instrumentation site is a guarded no-op.

Run from the repo root:

  PYTHONPATH=src python examples_torch/telemetry_quickstart.py [--device cpu]

Then load /tmp/simdram_trace.json in https://ui.perfetto.dev — two
track groups (measured vs modeled), one track per chip/bank lane.
"""

import argparse

import numpy as np

from repro_torch import obs
from repro_torch.core.bank import Bank, BbopInstr, Ref
from repro_torch.core.channel import SimdramChannel
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.kernels.build import resolve_device

U = np.uint64
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
    a = rng.integers(0, 256, 192).astype(U)
    b = rng.integers(0, 256, 192).astype(U)
    queue = [
        BbopInstr("addition", (a, b), 8),
        BbopInstr("multiplication", (Ref(0), b), 8),
        BbopInstr("greater", (a, b), 8),
    ]

    # -- 1. trace a multi-chip dispatch -------------------------------------
    with obs.enabled() as tr:
        channel = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2,
                                 device=device)
        results = channel.dispatch(queue)
        st = channel.stats

        root = tr.roots[-1]
        print("== span tree (one dispatch, two clocks) ==")
        depth_of = {id(root): 0}
        spans = []
        for sp in root.walk():
            d = depth_of[id(sp)]
            for child in sp.children:
                depth_of[id(child)] = d + 1
            lane = f" [{sp.lane}]" if sp.lane else ""
            print(f"  {'  ' * d}{sp.name}{lane}: "
                  f"wall {sp.wall_s * 1e6:8.1f} us, "
                  f"modeled {sp.modeled_total_s * 1e6:8.3f} us")
            spans.append([d, sp.name, sp.lane, sp.modeled_total_s])

        # the modeled clock is the SAME accumulation the Stats performed —
        # left-fold summation reproduces the FP addition order, so these
        # reconcile exactly, not approximately:
        print("\n== reconciliation (bit-for-bit) ==")
        print(f"  channel.replay   {tr.modeled_total('channel.replay'):.6e} "
              f"== stats.latency_s  {st.latency_s:.6e}  "
              f"-> {tr.modeled_total('channel.replay') == st.latency_s}")
        h2d = tr.modeled_total('channel.transfer.h2d')
        d2h = tr.modeled_total('channel.transfer.d2h')
        hid = tr.modeled_total('channel.transfer.overlapped')
        print(f"  transfer.h2d     {h2d:.6e} "
              f"== stats.transfer_h2d_s {st.transfer_h2d_s:.6e}  "
              f"-> {h2d == st.transfer_h2d_s}")
        print(f"  transfer.d2h     {d2h:.6e} "
              f"== stats.transfer_d2h_s {st.transfer_d2h_s:.6e}  "
              f"-> {d2h == st.transfer_d2h_s}")
        print(f"  transfer.overlap {hid:.6e} "
              f"== stats.transfer_overlapped_s "
              f"{st.transfer_overlapped_s:.6e}  "
              f"-> {hid == st.transfer_overlapped_s}")
        out["results"]["channel"] = [np.asarray(r).astype(np.int64).tolist()
                                     for r in results]
        out["modeled"]["spans"] = spans
        out["modeled"]["channel"] = {k: v for k, v in st.as_dict().items()
                                     if k not in MEASURED}
        out["modeled"]["reconciled"] = [
            tr.modeled_total('channel.replay') == st.latency_s,
            h2d == st.transfer_h2d_s, d2h == st.transfer_d2h_s,
            hid == st.transfer_overlapped_s]

        # -- 2. exporters ---------------------------------------------------
        trace = obs.write_chrome_trace("/tmp/simdram_trace.json")
        n = obs.write_jsonl("/tmp/simdram_spans.jsonl")
        print(f"\n== exporters ==\n  wrote /tmp/simdram_trace.json "
              f"({len(trace['traceEvents'])} events — open in "
              f"https://ui.perfetto.dev)\n  wrote /tmp/simdram_spans.jsonl "
              f"({n} span records)")
        print("  per-stage summary (scripts/trace_summary_torch.py prints "
              "this for any trace file):")
        summary = obs.stage_summary(trace)
        for row in summary[:5]:
            print(f"    {row['stage']:<26} x{row['count']} "
                  f"wall {row['wall_us']:8.1f} us  "
                  f"modeled {row['modeled_us']:8.3f} us")
        out["modeled"]["exported"] = [len(trace["traceEvents"]), n]
        out["modeled"]["summary"] = sorted(
            [r["stage"], r["count"], r["modeled_us"]] for r in summary)

        # -- 3. the metrics registry ----------------------------------------
        # Stats tiers publish into one process-wide registry; benchmarks
        # snapshot it as their single source of truth instead of
        # hand-copying fields into report dicts.
        obs.publish_stats(st, "channel.demo")
        snap = obs.REGISTRY.snapshot("channel.demo.")
        print(f"\n== registry ({len(snap)} gauges published) ==")
        for key in ("channel.demo.latency_s", "channel.demo.transfer_s",
                    "channel.demo.exposed_transfer_s",
                    "channel.demo.super_rounds",
                    "channel.demo.throughput_total_gops"):
            print(f"  {key} = {snap[key]:.6g}")
        out["modeled"]["registry"] = {
            k: v for k, v in snap.items() if not k.endswith(MEASURED)}

    # outside the scope: tracing is off again, instrumentation is free
    assert obs.active_tracer() is None

    # -- 4. flight recorder: post-mortem on a hopeless device ---------------
    with obs.enabled() as tr:
        doomed = Bank(n_subarrays=2,
                      fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                       spare_lanes=1, seed=1,
                                       max_redispatches=1),
                      device=device)
        try:
            doomed.dispatch(queue)
        except FaultExhaustedError:
            rec = tr.incidents[-1]
            print(f"\n== flight recorder ==\n  incident: {rec.reason} "
                  f"{rec.attrs}\n  ring holds {len(rec.roots)} dispatch "
                  f"tree(s) for post-mortem; open spans at capture: "
                  f"{rec.open_spans or 'none (unwound)'}")
            out["modeled"]["incident"] = [rec.reason, repr(rec.attrs),
                                          len(rec.roots),
                                          list(rec.open_spans or [])]

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
