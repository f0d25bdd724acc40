"""The rank tier + DMA transfer/replay overlap in five minutes.

The port's counterpart of ``examples/rank_overlap_quickstart.py``.
Walks the newest rung of the ladder top-down:

  1. a 2-channel × 2-chip × 2-bank SimdramRank drains a bbop queue —
     Ref chains stay channel-local, every rank round replays ALL
     channels' super-rounds in ONE K5 launch on the card (the port runs
     every unit of a round on one card, so its executor reads as the
     reference's single-device line);
  2. the DMA overlap timeline: the rank-shared host link is
     double-buffered against replay — round k+1's operands stream in
     and round k-1's results drain out while round k replays — so only
     the fill/drain edges and whatever traffic exceeds replay time is
     EXPOSED; the overlap knob degrades bit-exactly to the serial
     charge;
  3. RankStats: per-channel busy/programs/imbalance over the inherited
     per-chip surface, and the transfer-bound crossover computed on
     the exposed (post-overlap) time — overlap moves it outward.

Run:  PYTHONPATH=src python examples_torch/rank_overlap_quickstart.py [--device cpu]
"""

import argparse
from dataclasses import replace

import numpy as np

from repro_torch.core.bank import BbopInstr, Ref
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.ops_library import get_op
from repro_torch.core.rank import SimdramRank, sequential_rank_dispatch
from repro_torch.core.timing import DDR4
from repro_torch.kernels.build import resolve_device

MEASURED = ("wall_s", "pack_wall_s")


def _values(r):
    return np.asarray(r.to_values() if hasattr(r, "to_values") else r)


def build_queue(rng, lanes=256):
    """Enough independent work for several rank rounds — the overlap
    engine needs a steady-state window between fill and drain."""
    queue = []
    for op, n_bits in [("addition", 8), ("multiplication", 8),
                       ("greater", 8), ("subtraction", 8),
                       ("min", 8), ("max", 8)] * 4:
        spec = get_op(op, n_bits)
        ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                    for w in spec.operand_bits)
        queue.append(BbopInstr(op, ops, n_bits))
    base = len(queue)
    x, y = (rng.integers(0, 256, lanes).astype(np.uint64) for _ in range(2))
    queue.append(BbopInstr("multiplication", (x, y), 8))
    queue.append(BbopInstr("relu", (Ref(base),), 16, keep_vertical=True))
    return queue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}
    rng = np.random.default_rng(0)
    queue = build_queue(rng)

    # -- 1. the rank drains the queue in stacked rank rounds --------------
    rank = SimdramRank(n_channels=2, n_chips=2, n_banks=2, n_subarrays=2,
                       device=device)
    ex = rank.executor
    print("executor:", f"3-D shard_map over {dict(ex.mesh.shape)}"
          if ex.sharded else "single-device vmap over channels")
    results = rank.dispatch(queue)
    st = rank.stats
    print(f"dispatched {len(queue)} bbops -> {st.super_rounds} rank "
          f"rounds across {st.n_channels} channels "
          f"({st.n_chips} chips rank-wide)")

    seq_results, channels = sequential_rank_dispatch(
        queue, n_channels=2, n_chips=2, n_banks=2, n_subarrays=2,
        device=device)
    assert all(np.array_equal(_values(a), _values(b))
               for a, b in zip(results, seq_results))
    print("bit-exact vs sequential per-channel execution")
    seq_s = sum(ch.stats.latency_s for ch in channels)
    print(f"modeled latency   {st.latency_s * 1e6:8.1f} us  "
          f"(sequential channels: {seq_s * 1e6:.1f} us, "
          f"speedup x{seq_s / st.latency_s:.2f})")
    out["results"]["rank"] = [_values(r).astype(np.int64).tolist()
                              for r in results]
    out["modeled"]["sequential_s"] = seq_s

    # -- 2. the DMA overlap timeline ---------------------------------------
    #
    #   h2d   |op0|op1    |op2    |...         |           fill
    #   replay    |round 0|round 1|...|round n |
    #   d2h           |res0   |res1   |...     |res n|     drain
    #
    # While round k replays, the DMA engine streams round k+1's
    # operands in and drains round k-1's results out.  Only round 0's
    # fill, the last round's drain, and any slot where traffic
    # outlasts replay are exposed.
    print(f"\ntransfer (serial) {st.transfer_s * 1e6:8.2f} us  "
          f"= h2d {st.transfer_h2d_s * 1e6:.2f} + "
          f"d2h {st.transfer_d2h_s * 1e6:.2f} "
          f"({st.transfer_bytes} B, burst-rounded to "
          f"{rank.cfg.link_burst_bytes} B)")
    print(f"  overlapped      {st.transfer_overlapped_s * 1e6:8.2f} us  "
          f"hidden behind replay")
    print(f"  exposed         {st.exposed_transfer_s * 1e6:8.2f} us  "
          f"reaches total_latency_s ({st.total_latency_s * 1e6:.1f} us)")

    # the knob degrades bit-exactly to the serial engine
    serial = SimdramRank(n_channels=2, n_chips=2, n_banks=2, n_subarrays=2,
                         cfg=replace(DDR4, transfer_overlap=False),
                         device=device)
    serial.dispatch(build_queue(np.random.default_rng(0)))
    ss = serial.stats
    assert ss.transfer_h2d_s == st.transfer_h2d_s
    assert ss.transfer_d2h_s == st.transfer_d2h_s
    assert ss.exposed_transfer_s == ss.transfer_s
    print(f"overlap OFF       {ss.exposed_transfer_s * 1e6:8.2f} us "
          f"exposed (== the full serial charge, same link totals "
          f"bit-for-bit)")

    # -- 3. RankStats + the crossover moving outward -----------------------
    print(f"\nchannel programs  {st.channel_programs}")
    print(f"channel busy      {np.round(st.channel_busy_s * 1e6, 1)} us  "
          f"(imbalance {st.channel_imbalance:.2f}; 1.0 = perfect)")
    print(f"chip programs     {st.chip_programs}  (channel-major)")
    print(f"crossover         {st.crossover_chips:8.1f} chips with overlap "
          f"vs {ss.crossover_chips:.1f} serial — hiding transfer time "
          f"extends how far adding chips keeps helping")
    out["modeled"]["rank"] = {k: v for k, v in st.as_dict().items()
                              if k not in MEASURED}
    out["modeled"]["serial"] = {k: v for k, v in ss.as_dict().items()
                                if k not in MEASURED}
    out["modeled"]["channel_busy_s"] = np.asarray(st.channel_busy_s).tolist()
    out["modeled"]["channel_programs"] = list(st.channel_programs)
    out["modeled"]["chip_programs"] = list(st.chip_programs)

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
