"""Read how far ``chip_smoke.py`` phase 18a's partitioned train steps lie
from the unpartitioned step on the card, over several seeds and runs,
and how far its planted faults read, to set its tolerance
``TRAIN_PARTITION_REL``.

    PYTHONPATH=src python experiments/partition_train_tolerance.py \\
        [--seeds 29 401 402 403 404 405] [--runs 2] [--json PATH]

For each seed, on weights and batches from a seeded generator on the
card, ``chip_smoke.partition_train_steps`` runs 18a's internvl2-1b
(``TRAIN_PARTITION_LAYERS`` of its 24 layers at its published width,
bf16 params, float32 moments; ``TRAIN_PARTITION_STEPS`` steps of
``TRAIN_PARTITION_BATCH`` x ``TRAIN_PARTITION_SEQ`` tokens) over each
(mesh, microbatches) of ``TRAIN_PARTITION_MESHES``, ``--runs`` times,
each mesh over ``cuda:0`` repeated (or the visible cards).  A sound
reading is the loss's and grad_norm's |partitioned - unpartitioned|
over their value and each leaf's max|mu difference| over its
max|mu|; the faults (``chip_smoke.TRAIN_FAULTS``), planted into the
(2, 2) run's first step, are data rank 1's partial dropped from the
first reduce-scatter, ln_f's gain's gradient summed over ``model`` as
well, and each position's own rows as its microbatches.  Prints, per run and over all,
the largest sound reading and the smallest fault reading.  Needs a CUDA
card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[29, 401, 402, 403, 404, 405])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("partition_train_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    cfg = get_config(cs.TRAIN_PARTITION_ARCH).replace(
        n_layers=cs.TRAIN_PARTITION_LAYERS)
    readings = []
    for seed in args.seeds:
        params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
            seed), device=dev)
        batches = cs._partition_batches(
            cfg, dev, cs.TRAIN_PARTITION_BATCH, cs.TRAIN_PARTITION_SEQ,
            cs.TRAIN_PARTITION_STEPS, seed)
        for sizes, n_mb in cs.TRAIN_PARTITION_MESHES:
            mesh, where = cs._split_mesh(sizes, ("data", "model"))
            for r in range(args.runs):
                faults = cs.TRAIN_FAULTS if sizes == cs.PARTITION_MESH \
                    and r == 0 else ()
                run = cs.partition_train_steps(
                    dev, cfg, params, mesh, n_mb=n_mb, batches=batches,
                    opt_kw=cs.TRAIN_PARTITION_OPT, faults=faults)
                one = {"seed": seed, "run": r, "mesh": list(sizes),
                       "microbatches": n_mb, "devices": where,
                       "mode": run["mode"], "sound_max": run["rel_max"],
                       "loss_rel": run["loss_rel"],
                       "grad_norm_rel": run["grad_norm_rel"],
                       "mu_rel": run["mu_rel"], "faults": run["faults"],
                       "ms": run["ms"], "plain_ms": run["plain_ms"]}
                readings.append(one)
                print(f"seed {seed} run {r} over {sizes} ({run['mode']} "
                      f"split, {n_mb} microbatch(es)): sound at most "
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
           "sound_max": max(r["sound_max"] for r in readings),
           "fault_min": min(faults)}
    print(f"over {len(args.seeds)} seeds x {args.runs} runs x "
          f"{len(cs.TRAIN_PARTITION_MESHES)} meshes: sound at most "
          f"{out['sound_max']:.4e}, the faults at least "
          f"{out['fault_min']:.4e}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
