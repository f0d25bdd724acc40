"""Multi-chip channel execution in five minutes.

The port's counterpart of ``examples/channel_quickstart.py``.  Walks the
channel tier bottom-up:

  1. a 2-chip × 2-bank SimdramChannel drains a heterogeneous bbop queue
     — Ref chains stay chip-local, every super-round replays ALL chips'
     rounds in ONE K5 launch on the card (the port runs every unit of a
     round on one card, so its executor reads as the reference's
     single-device line);
  2. ChannelStats: per-chip utilization, cross-chip imbalance, the
     modeled-vs-measured latency pair, AND the DMA transfer bound — the
     host↔chip traffic priced per direction (``h2d_bw_gbs`` /
     ``d2h_bw_gbs``, defaulting to ``channel_bw_gbs``), burst-rounded,
     shared by all chips, and overlapped against replay so only the
     exposed remainder reaches the end-to-end latency, with the
     crossover chip count where it starts to dominate (see
     examples_torch/rank_overlap_quickstart.py for the overlap timeline);
  3. the compute-side 1/2/4-chip throughput curve from the timing
     model, against the bandwidth-bound transfer wall.

Run:  PYTHONPATH=src python examples_torch/channel_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.bank import BbopInstr, Ref
from repro_torch.core.channel import (SimdramChannel,
                                      sequential_channel_dispatch)
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.isa import compile_op
from repro_torch.core.ops_library import get_op
from repro_torch.core.timing import (DDR4, channel_throughput_gops,
                                     host_transfer_s)
from repro_torch.kernels.build import resolve_device

MEASURED = ("wall_s", "pack_wall_s")


def _values(r):
    return np.asarray(r.to_values() if hasattr(r, "to_values") else r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}
    rng = np.random.default_rng(0)
    lanes = 256

    # -- 1. heterogeneous queue with chains across a 2-chip channel ------
    queue = []
    for op, n_bits in [("addition", 8), ("multiplication", 8),
                       ("greater", 8), ("xor_red", 16)] * 2:
        spec = get_op(op, n_bits)
        ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                    for w in spec.operand_bits)
        queue.append(BbopInstr(op, ops, n_bits))
    x, y = (rng.integers(0, 256, lanes).astype(np.uint64) for _ in range(2))
    base = len(queue)
    queue.append(BbopInstr("multiplication", (x, y), 8))
    queue.append(BbopInstr("relu", (Ref(base),), 16, keep_vertical=True))

    channel = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                             device=device)
    ex = channel.executor
    print("executor:", f"2-D shard_map over {dict(ex.mesh.shape)}"
          if ex.sharded else "single-device vmap over chips")
    results = channel.dispatch(queue)
    print(f"dispatched {len(queue)} bbops -> {channel.stats.super_rounds} "
          f"super-rounds ({channel.stats.batches} bank waves)")

    seq_results, chips = sequential_channel_dispatch(
        queue, n_chips=2, n_banks=2, n_subarrays=2, device=device)
    assert all(np.array_equal(_values(a), _values(b))
               for a, b in zip(results, seq_results))
    print("bit-exact vs sequential per-chip execution")
    out["results"]["channel"] = [_values(r).astype(np.int64).tolist()
                                 for r in results]

    # -- 2. ChannelStats: concurrency + the transfer bound ----------------
    st = channel.stats
    seq_s = sum(c.stats.latency_s for c in chips)
    print(f"\nmodeled latency   {st.latency_s * 1e6:8.1f} us  "
          f"(sequential chips: {seq_s * 1e6:.1f} us, "
          f"speedup x{seq_s / st.latency_s:.2f})")
    print(f"transfer          {st.transfer_s * 1e6:8.2f} us  "
          f"({st.transfer_bytes} B over the shared "
          f"{channel.cfg.channel_bw_gbs} GB/s link — does NOT shrink "
          f"with more chips)")
    print(f"  overlapped      {st.transfer_overlapped_s * 1e6:8.2f} us  "
          f"(hidden behind replay by the DMA double-buffer)")
    print(f"  exposed         {st.exposed_transfer_s * 1e6:8.2f} us  "
          f"(what reaches the end-to-end latency)")
    print(f"end-to-end        {st.total_latency_s * 1e6:8.1f} us  "
          f"(crossover ~{st.crossover_chips:.1f} chips: beyond that the "
          f"channel, not compute, is the bound)")
    print(f"measured wall     {st.wall_s * 1e6:8.1f} us  "
          f"(host pack: {st.pack_wall_s * 1e6:.1f} us; first dispatch "
          f"includes the kernel builds on a fresh checkout)")
    print(f"chip programs     {st.chip_programs}")
    print(f"chip utilization  {np.round(st.utilization, 2)}")
    print(f"cross-chip imbalance {st.imbalance:.2f} (1.0 = perfect)")
    out["modeled"]["channel"] = {k: v for k, v in st.as_dict().items()
                                 if k not in MEASURED}
    out["modeled"]["sequential_s"] = seq_s
    out["modeled"]["chip_programs"] = list(st.chip_programs)
    out["modeled"]["utilization"] = np.asarray(st.utilization).tolist()

    # -- 3. the 1/2/4-chip curve vs the transfer wall ---------------------
    _, up = compile_op("addition", 16)
    n_elems = 1 << 20
    wall_s = host_transfer_s(n_elems * (16 + 16 + 16) / 8, DDR4)
    print("\nmodeled add16 throughput (chips × 4 banks × 2 subarrays), "
          f"vs moving {n_elems} elements across the channel:")
    for nc in (1, 2, 4):
        gops = channel_throughput_gops(up, DDR4, n_chips=nc, n_banks=4,
                                       n_subarrays=2)
        compute_s = n_elems / (gops * 1e9)
        bound = "transfer-bound" if wall_s > compute_s else "compute-bound"
        print(f"  {nc} chips: {gops:8.2f} GOps/s  "
              f"(compute {compute_s * 1e6:7.1f} us vs transfer "
              f"{wall_s * 1e6:.1f} us -> {bound})")
        out["modeled"][f"chips_{nc}"] = [gops, compute_s, wall_s, bound]

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
