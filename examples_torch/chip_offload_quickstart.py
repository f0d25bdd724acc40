"""Chip-level execution + serving-path PuM offload in five minutes.

The port's counterpart of ``examples/chip_offload_quickstart.py``.
Walks the chip subsystem bottom-up:

  1. a 4-bank SimdramChip drains a heterogeneous bbop queue — the
     bin-packing scheduler spreads Ref chains across banks, every chip
     round replays all banks in ONE K5 launch on the card (the port
     runs every unit of a round on one card, so its executor reads as
     the reference's single-device line);
  2. ChipStats: per-bank utilization, cross-bank imbalance, and the
     modeled-vs-measured latency pair;
  3. the paper's 1/4/16-bank throughput curve from the timing model;
  4. PumServeOffload: a continuous-batching LM server routing every
     decode step's quantized elementwise logit stages through the chip.

Run:  PYTHONPATH=src python examples_torch/chip_offload_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.bank import BbopInstr, Ref
from repro_torch.core.chip import SimdramChip, sequential_dispatch
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.isa import compile_op
from repro_torch.core.ops_library import get_op
from repro_torch.core.timing import DDR4, chip_throughput_gops
from repro_torch.kernels.build import resolve_device

MEASURED = ("wall_s", "pack_wall_s")


def _values(r):
    return np.asarray(r.to_values() if hasattr(r, "to_values") else r)


def main(argv=None, params=None):
    """``params``: the LM's weights (a tree of tensors, e.g. another
    package's init carried across with ``params_from_numpy``); by default
    ``init_lm`` draws them from a CPU generator seeded with 0, so the card
    and the CPU run the same weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}
    rng = np.random.default_rng(0)
    lanes = 256

    # -- 1. heterogeneous queue with chains across a 4-bank chip ---------
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

    chip = SimdramChip(n_banks=4, n_subarrays=2, device=device)
    ex = chip.executor
    print(f"executor: {'shard_map over ' + str(ex.mesh) if ex.sharded else 'single-device vmap over banks'}")
    results = chip.dispatch(queue)
    print(f"dispatched {len(queue)} bbops -> {chip.stats.rounds} chip "
          f"rounds ({chip.stats.batches} bank waves)")

    seq_results, banks = sequential_dispatch(queue, n_banks=4, n_subarrays=2,
                                             device=device)
    assert all(np.array_equal(_values(a), _values(b))
               for a, b in zip(results, seq_results))
    print("bit-exact vs sequential per-bank execution")
    out["results"]["chip"] = [_values(r).astype(np.int64).tolist()
                              for r in results]

    # -- 2. ChipStats -----------------------------------------------------
    st = chip.stats
    seq_s = sum(b.stats.latency_s for b in banks)
    print(f"\nmodeled latency   {st.latency_s * 1e6:8.1f} us  "
          f"(sequential banks: {seq_s * 1e6:.1f} us, "
          f"speedup x{seq_s / st.latency_s:.2f})")
    print(f"measured wall     {st.wall_s * 1e6:8.1f} us  "
          f"(host pack: {st.pack_wall_s * 1e6:.1f} us; first dispatch "
          f"includes the kernel builds on a fresh checkout)")
    print(f"bank programs     {st.bank_programs}")
    print(f"bank utilization  {np.round(st.utilization, 2)}")
    print(f"cross-bank imbalance {st.imbalance:.2f} (1.0 = perfect)")
    out["modeled"]["chip"] = {k: v for k, v in st.as_dict().items()
                              if k not in MEASURED}
    out["modeled"]["sequential_s"] = seq_s
    out["modeled"]["bank_programs"] = list(st.bank_programs)
    out["modeled"]["utilization"] = np.asarray(st.utilization).tolist()

    # -- 3. the paper's 1/4/16-bank curve ---------------------------------
    _, up = compile_op("addition", 16)
    print("\nmodeled add16 throughput (paper-style bank sweep):")
    for nb in (1, 4, 16):
        gops = chip_throughput_gops(up, DDR4, n_banks=nb)
        print(f"  {nb:2d} banks: {gops:8.2f} GOps/s")
        out["modeled"][f"gops_{nb}"] = gops

    # -- 4. serving-path offload -----------------------------------------
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve import PumServeOffload, Request, Server

    cfg = smoke_config("yi-6b").replace(n_layers=2)
    if params is None:
        params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    offload = PumServeOffload(
        chip=SimdramChip(n_banks=2, n_subarrays=2, device=device),
        device=device)
    server = Server(cfg, params, batch_slots=2, max_len=32,
                    pum_offload=offload, device=device)
    logits = _record_logits(server)
    reqs = [Request(prompt=[5, 6, 7], max_new=4), Request(prompt=[9], max_new=4)]
    for r in reqs:
        server.submit(r)
    server.run(max_steps=64)
    cs = offload.chip.stats
    print(f"\nserver decoded {[r.out for r in reqs]} with every step's "
          f"logit stages on the chip:")
    print(f"  {cs.bbops} bbops in {cs.rounds} chip rounds, "
          f"{cs.transpositions_skipped} transpositions skipped, "
          f"bank programs {cs.bank_programs}")
    out["lm"] = {"tokens": [list(r.out) for r in reqs], "logits": logits}
    out["modeled"]["offload"] = [cs.bbops, cs.rounds,
                                 cs.transpositions_skipped,
                                 list(cs.bank_programs)]

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


def _record_logits(server):
    """Keep each decode step's logits (float32, on the host) as the
    server computes them, for holding two runs' tokens under a margin
    rule: a list the server's steps append to."""
    import torch
    logits, step_fn = [], server.step_fn

    def recording(*args):
        lg, caches = step_fn(*args)
        logits.append(lg.to(torch.float32).cpu().numpy())
        return lg, caches

    server.step_fn = recording
    return logits


if __name__ == "__main__":
    main()
