"""Read how far ``chip_smoke.py`` phase 21's partitioned steps lie from
the unpartitioned steps on the card, over several seeds, and how far its
planted faults read, to set its tolerances.

    PYTHONPATH=src python experiments/partition_close_tolerance.py \\
        [--seeds 41 701 702 703 704 705] [--only dense|transform|caches] \\
        [--json PATH]

For each seed, on weights and inputs from a seeded generator on the
card, under deterministic algorithms for the serving runs as the smoke
runs them: ``chip_smoke.close_dense_run`` (21a: granite-moe-1b-a400m
with ``moe_impl="dense"``, its prefill and decode steps, model rank 1's
expert partial dropped), ``chip_smoke.close_transform_run`` (21b:
internvl2-1b's train steps with ``compressed_grad_transform``, the
transform applied to each shard) and ``chip_smoke.close_caches_run``
(21c: a yi-6b decode from caches handed outside ``cache_shardings``'
layout, the caches not relaid).  A sound reading is each row's
max|partitioned - unpartitioned| logit over the row's max|logit|, each
cache shard's over its max|value|, the loss's and grad_norm's relative
difference, each leaf's max|mu difference| over its max|mu| and (21b)
the share of ``mu`` entries that moved by more than
``CLOSE_MOVED_EPS`` of their leaf's max|mu|; a fault reading is the
first step's so read.  21a's steps are read in bf16 too, with
``moe_impl="dense"`` and ``"grouped"`` (the readings that keep 21a in
``CLOSE_DENSE_DTYPE``), and grouped in float32.  Prints, per run and over all, the largest sound
reading and the smallest fault reading.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[41, 701, 702, 703, 704, 705])
    ap.add_argument("--only", choices=("dense", "transform", "caches"),
                    help="read only one of the three runs")
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import gc

    import torch
    import torch.utils.deterministic as deterministic
    if not torch.cuda.is_available():
        print("partition_close_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "experiments"), str(ROOT)]
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    readings = []

    def serving(run):
        torch.use_deterministic_algorithms(True)
        deterministic.fill_uninitialized_memory = False
        try:
            return run()
        finally:
            torch.use_deterministic_algorithms(False)
            deterministic.fill_uninitialized_memory = True

    for seed in args.seeds:
        one = {"seed": seed}
        if args.only in (None, "dense"):
            run, _, _ = serving(lambda: cs.close_dense_run(dev, seed))
            one["dense"] = {"sound": max(run["rel_max"], run["cache_rel"]),
                            "fault": float(run["faults"]["drop"].max())}
            del run
            # the same steps in bf16, dense and grouped (the readings that
            # keep 21a in float32), and grouped in float32
            for dtype, impl in (("bfloat16", "dense"),
                                ("bfloat16", "grouped"),
                                ("float32", "grouped")):
                run, _, _ = serving(lambda: cs.close_dense_run(
                    dev, seed, faults=(), dtype=dtype, impl=impl))
                one[f"{dtype} {impl}"] = {
                    "sound": max(run["rel_max"], run["cache_rel"])}
                del run
        if args.only in (None, "transform"):
            run, _, _ = cs.close_transform_run(dev, seed)
            one["transform"] = {
                "sound": run["rel_max"], "moved": max(run["mu_moved"]),
                "fault": run["faults"]["shard"],
                "fault_moved": run["faults_moved"]["shard"]}
            del run
        if args.only in (None, "caches"):
            run, _, _ = serving(lambda: cs.close_caches_run(dev, seed))
            one["caches"] = {"sound": max(run["rel_max"], run["cache_rel"]),
                             "fault": float(run["faults"]["relabel"].max())}
            del run
        gc.collect()
        torch.cuda.empty_cache()
        readings.append(one)
        print(f"[seed {seed}] " + json.dumps(
            {k: v for k, v in one.items() if k != "seed"}) + f"; {card}",
            flush=True)
    summary = {}
    for key in ("dense", "bfloat16 dense", "bfloat16 grouped",
                "float32 grouped", "transform", "caches"):
        got = [r[key] for r in readings if key in r]
        if got:
            summary[key] = {f"{k}_{'max' if 'fault' not in k else 'min'}":
                            float((np.max if "fault" not in k else np.min)(
                                [g[k] for g in got])) for k in got[0]}
    print("[summary] " + json.dumps(summary) + f"; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "readings": readings, "summary": summary},
            indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
