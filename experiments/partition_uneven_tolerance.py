"""Read how far ``chip_smoke.py`` phase 22's partitioned steps lie from
the unpartitioned steps on the card, over several seeds, and how far its
planted faults read, to set its tolerances.

    PYTHONPATH=src python experiments/partition_uneven_tolerance.py \\
        [--seeds 43 801 802 803 804 805] [--only serve|train] [--json PATH]

For each seed, on weights and inputs from a seeded generator on the
card: ``chip_smoke.uneven_serve_run`` (22a: hymba-1.5b's prefill and
decode over (1, 3), its SSD, conv and attention whole at every model
rank; the whole SSD output summed over ``model`` planted) and
``chip_smoke.uneven_train_run`` (22b: mamba2-370m's train steps over
(2, 3), 3 rows a microbatch over 2 data parts; the conv gather's
``copies`` transpose dropped, and a per-position mean of the loss,
planted).  A sound reading is each row's max|partitioned -
unpartitioned| logit over the row's max|logit|, each cache shard's over
its max|value|, the loss's and grad_norm's relative difference and each
leaf's max|mu difference| over its max|mu|; a fault reading is the
first step's so read.  Prints, per seed and over all, the largest sound
reading and the smallest fault reading.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[43, 801, 802, 803, 804, 805])
    ap.add_argument("--only", choices=("serve", "train"),
                    help="read only one of the two runs")
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import gc

    import torch
    if not torch.cuda.is_available():
        print("partition_uneven_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "experiments"), str(ROOT)]
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    readings = []
    for seed in args.seeds:
        one = {"seed": seed}
        if args.only in (None, "serve"):
            run, _, _ = cs.uneven_serve_run(dev, seed)
            one["serve"] = {"sound": max(run["rel_max"], run["cache_rel"]),
                            **{f"fault {k}": v
                               for k, v in run["faults"].items()}}
            del run
        if args.only in (None, "train"):
            run, _, _ = cs.uneven_train_run(dev, seed)
            one["train"] = {"sound": run["rel_max"],
                            **{f"fault {k}": v
                               for k, v in run["faults"].items()}}
            del run
        gc.collect()
        torch.cuda.empty_cache()
        readings.append(one)
        print(f"[seed {seed}] " + json.dumps(
            {k: v for k, v in one.items() if k != "seed"}) + f"; {card}",
            flush=True)
    summary = {}
    for key in ("serve", "train"):
        got = [r[key] for r in readings if key in r]
        if got:
            summary[key] = {
                f"{k}_{'min' if k.startswith('fault') else 'max'}":
                float(min(g[k] for g in got) if k.startswith("fault")
                      else max(g[k] for g in got)) for k in got[0]}
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
