"""Read how far ``chip_smoke.py`` phase 17's partitioned serving steps
lie from the unpartitioned steps on the card, over several seeds, and
how far its planted faults read, to set its tolerance
``PARTITION_REL``.

    PYTHONPATH=src python experiments/partition_tolerance.py \
        [--seeds 23 301 302 303 304 305] [--json PATH]

For each seed, under deterministic algorithms and on weights from a
seeded generator on the card (bf16), ``chip_smoke.partition_steps``
runs 17a's yi-6b (``PARTITION_LAYERS`` of its 32 layers; a prefill of
``PARTITION_ROWS`` x ``PARTITION_PREFILL`` tokens, then
``PARTITION_STEPS`` decode steps) over ``PARTITION_MESH``, and 17b's
internvl2-1b (all 24 layers, ``PARTITION_VLM_STEPS`` decode steps of
``PARTITION_VLM_ROWS`` rows against ``PARTITION_VLM_CACHE`` positions)
over ``PARTITION_MESH`` and ``PARTITION_UNEVEN_MESH``, each mesh over
the visible cards or ``cuda:0`` repeated.  A sound reading is a row's
max|partitioned - unpartitioned| over its max|logit| (or a cache
shard's written slots over their max|value|); the faults, planted into
each run's first decode step, are model rank 1's partial dropped from
the all-reduce ``PARTITION_DROP`` (layer 3's MLP output) and positions
1 and 2 computing on each other's cache shards.  Prints, per run and over
all, the largest sound reading and the smallest of the faults' largest
readings.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[23, 301, 302, 303, 304, 305])
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    # deterministic algorithms, as in the smoke
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("partition_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.utils.deterministic as deterministic

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    runs = [(cs.PARTITION_ARCH, cs.PARTITION_LAYERS, cs.PARTITION_MESH,
             dict(rows=cs.PARTITION_ROWS, cache_len=cs.PARTITION_CACHE,
                  steps=cs.PARTITION_STEPS,
                  prefill_len=cs.PARTITION_PREFILL))]
    for sizes in (cs.PARTITION_MESH, cs.PARTITION_UNEVEN_MESH):
        runs.append((cs.PARTITION_VLM, None, sizes,
                     dict(rows=cs.PARTITION_VLM_ROWS,
                          cache_len=cs.PARTITION_VLM_CACHE,
                          steps=cs.PARTITION_VLM_STEPS)))
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    readings = []
    for seed in args.seeds:
        for arch, layers, sizes, kw in runs:
            cfg = get_config(arch)
            if layers:
                cfg = cfg.replace(n_layers=layers)
            params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
                seed), device=dev)
            mesh, where = cs._split_mesh(sizes, ("data", "model"))
            run = cs.partition_steps(dev, cfg, params, mesh, seed=seed,
                                     faults=("drop", "swap"), **kw)
            one = {"seed": seed, "arch": arch, "layers": cfg.n_layers,
                   "mesh": list(sizes), "devices": where,
                   "mode": run["mode"], "sound_max": run["rel_max"],
                   "cache_max": run["cache_rel"],
                   "cache_outside_equal": run["cache_outside_equal"],
                   "faults_max": {k: float(v.max())
                                  for k, v in run["faults"].items()},
                   "step_ms": run["ms"], "plain_ms": run["plain_ms"]}
            one["fault_min"] = min(one["faults_max"].values())
            readings.append(one)
            print(f"seed {seed} {arch} ({cfg.n_layers} layers) over {sizes} "
                  f"({run['mode']} split): sound at most "
                  f"{one['sound_max']:.4e} (logits), {one['cache_max']:.4e} "
                  f"(written cache slots); faults "
                  + ", ".join(f"{k} {v:.4e}"
                              for k, v in one["faults_max"].items())
                  + f"; {card}", flush=True)
            del params, run
            torch.cuda.empty_cache()
    out = {"card": card, "readings": readings,
           "sound_max": max(max(r["sound_max"], r["cache_max"])
                            for r in readings),
           "fault_min": min(r["fault_min"] for r in readings)}
    print(f"over {len(args.seeds)} seeds and {len(runs)} runs each: sound at "
          f"most {out['sound_max']:.4e}, the faults at least "
          f"{out['fault_min']:.4e} (as fractions of each row's or shard's "
          f"max|value|); {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
