"""Read how far ``chip_smoke.py`` phase 19's partitioned SSM and hybrid
steps lie from the unpartitioned steps on the card, over several seeds,
and how far its planted faults read, to set its tolerance
``SSM_PARTITION_REL``.

    PYTHONPATH=src python experiments/partition_ssm_tolerance.py \\
        [--seeds 31 501 502 503 504 505] [--only serve|train] [--json PATH]

For each seed, on weights and inputs from a seeded generator on the
card, ``chip_smoke.mesh_serving_steps`` runs 19a's mamba2-370m and 19b's
hymba-1.5b (all layers at their published widths, bf16: the prefill of
``SSM_*_PREFILL`` and ``SSM_DECODE_STEPS`` decode steps of
``SSM_*_DECODE``) over each mesh of ``SSM_MESHES`` (``cuda:0``
repeated, or the visible cards), with the faults of ``SSM_FAULTS``
planted into the first decode step; then ``chip_smoke.
partition_train_steps`` runs 19c's train steps (in SSD chunks of
``SSM_TRAIN_CHUNK``, ``SSM_TRAIN_DTYPE`` params, the faults of
``SSM_TRAIN_FAULTS`` planted into mamba2-370m's (2, 2) run).  A sound reading is each
row's max|partitioned - unpartitioned| logit over the row's max|logit|,
each cache shard's over its max|value|, the loss's and grad_norm's
relative difference and each leaf's max|mu difference| over its
max|mu|; a fault reading is the first decode step's logits so read.
Prints, per run and over all, the largest sound reading and the
smallest fault reading.  Needs a CUDA card.
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
                    default=[31, 501, 502, 503, 504, 505])
    ap.add_argument("--only", choices=("serve", "train"),
                    help="read only the serving or only the train steps")
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("partition_ssm_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    readings = []
    serve = () if args.only == "train" else (
        (cs.SSM_MAMBA, cs.SSM_MAMBA_PREFILL, cs.SSM_MAMBA_DECODE),
        (cs.SSM_HYMBA, cs.SSM_HYMBA_PREFILL, cs.SSM_HYMBA_DECODE))
    train = () if args.only == "serve" else (
        (cs.SSM_MAMBA, cs.SSM_MAMBA_TRAIN_LAYERS,
         (((2, 2), 2), ((1, 4), 1))),
        (cs.SSM_HYMBA, cs.SSM_HYMBA_TRAIN_LAYERS, (((1, 4), 1),)))
    for seed in args.seeds:
        for arch, pre, dec in serve:
            cfg = get_config(arch)
            params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
                seed), device=dev)
            for sizes in cs.SSM_MESHES:
                mesh, where = cs._split_mesh(sizes, ("data", "model"))
                run = cs.mesh_serving_steps(
                    dev, cfg, params, mesh, prefill=pre, decode=dec,
                    steps=cs.SSM_DECODE_STEPS, seed=seed,
                    faults=cs.SSM_FAULTS.get((arch, tuple(sizes)), ()))
                one = {"seed": seed, "arch": arch, "kind": "serve",
                       "mesh": list(sizes), "devices": where,
                       "sound_max": run["rel_max"],
                       "prefill_rel": float(run["prefill_rel"].max()),
                       "decode_rel": max(float(r.max())
                                         for r in run["rel"]),
                       "cache_rel": run["cache_rel"],
                       "cache_leaf_rel": run["cache_leaf_rel"],
                       "ms": run["ms"], "plain_ms": run["plain_ms"],
                       "faults": run["faults"]}
                readings.append(one)
                print(f"seed {seed} {arch} over {sizes}: sound at most "
                      f"{one['sound_max']:.4e} (prefill "
                      f"{one['prefill_rel']:.3e}, decode "
                      f"{one['decode_rel']:.3e}, caches "
                      + ", ".join(f"{k} {v:.3e}" for k, v in
                                  run["cache_leaf_rel"].items()) + ")"
                      + "".join(f"; fault {k} {v:.4e}"
                                for k, v in run["faults"].items())
                      + f"; {card}", flush=True)
                del run
            del params
            torch.cuda.empty_cache()
        rows, seq, n_steps = cs.SSM_TRAIN
        for arch, layers, cases in train:
            full = get_config(arch)
            cfg = full.replace(n_layers=layers or full.n_layers,
                               ssm_chunk=cs.SSM_TRAIN_CHUNK,
                               param_dtype=cs.SSM_TRAIN_DTYPE)
            params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
                seed + 1), device=dev)
            batches = cs._partition_batches(cfg, dev, rows, seq, n_steps,
                                            seed + 1)
            for sizes, n_mb in cases:
                mesh, where = cs._split_mesh(sizes, ("data", "model"))
                run = cs.partition_train_steps(
                    dev, cfg, params, mesh, n_mb=n_mb, batches=batches,
                    opt_kw=cs.SSM_TRAIN_OPT,
                    faults=cs.SSM_TRAIN_FAULTS if (arch, sizes) == (
                        cs.SSM_MAMBA, (2, 2)) else (),
                    plant=lambda name: cs.planted_ssm_fault(name, cfg))
                one = {"seed": seed, "arch": arch, "kind": "train",
                       "layers": cfg.n_layers, "mesh": list(sizes),
                       "microbatches": n_mb, "devices": where,
                       "sound_max": run["rel_max"],
                       "loss_rel": run["loss_rel"],
                       "grad_norm_rel": run["grad_norm_rel"],
                       "mu_rel": run["mu_rel"], "faults": run["faults"],
                       "ms": run["ms"], "plain_ms": run["plain_ms"]}
                readings.append(one)
                print(f"seed {seed} {arch} train over {sizes} ({n_mb} "
                      f"microbatch(es)): sound at most "
                      f"{one['sound_max']:.4e} (loss "
                      f"{max(run['loss_rel']):.3e}, grad_norm "
                      f"{max(run['grad_norm_rel']):.3e}, mu "
                      f"{max(run['mu_rel']):.3e})"
                      + "".join(f"; fault {k} {v:.4e}"
                                for k, v in run["faults"].items())
                      + f"; {card}", flush=True)
                del run
            del params, batches
            torch.cuda.empty_cache()
    faults = [v for r in readings for v in r["faults"].values()]
    out = {"card": card, "readings": readings,
           "sound_max": float(np.max([r["sound_max"] for r in readings])),
           "fault_min": float(np.min(faults)) if faults else None}
    print(f"over {len(args.seeds)} seeds: sound at most "
          f"{out['sound_max']:.4e}, the faults at least "
          f"{out['fault_min']}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
