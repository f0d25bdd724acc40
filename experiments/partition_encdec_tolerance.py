"""Read how far ``chip_smoke.py`` phase 20's partitioned encoder-decoder
and int8 steps lie from the unpartitioned steps on the card, over several
seeds, and how far its planted faults read, to set its tolerances
``ENCDEC_PARTITION_REL`` and ``INT8_PARTITION_REL``.

    PYTHONPATH=src python experiments/partition_encdec_tolerance.py \\
        [--seeds 37 601 602 603 604 605] [--only encdec|train|int8] \\
        [--json PATH]

For each seed, on weights and inputs from a seeded generator on the
card: ``chip_smoke.mesh_serving_steps`` runs 20a's seamless-m4t-medium
(12 + 12 layers, bf16; the prefill of ``ENCDEC_PREFILL`` and
``ENCDEC_DECODE_STEPS`` decode steps of ``ENCDEC_DECODE``) over each
mesh of ``ENCDEC_MESHES`` with the faults of ``ENCDEC_FAULTS``;
``chip_smoke.partition_train_steps`` its train steps (20b: ``ENCDEC_TRAIN``,
``ENCDEC_TRAIN_LAYERS`` layers, float32, ln_f's fault); and each case of
``INT8_CASES`` (20c) with its faults.  A sound reading is each row's
max|partitioned - unpartitioned| logit over the row's max|logit|, each
cache shard's over its max|value|, the loss's and grad_norm's relative
difference and each leaf's max|mu difference| over its max|mu|; a fault
reading is the first decode step's (or train step's ``mu``) so read.
Prints, per run and over all, the largest sound reading and the smallest
fault reading, for the enc-dec runs and the int8 runs apart.  Needs a
CUDA card.
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
                    default=[37, 601, 602, 603, 604, 605])
    ap.add_argument("--only", choices=("encdec", "train", "int8"),
                    help="read only one of the three groups of runs")
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("partition_encdec_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.quantized import quantize_tree
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    readings = []

    def keep(one: dict, line: str) -> None:
        readings.append(one)
        print(line + "".join(f"; fault {k} {v:.4e}"
                             for k, v in one["faults"].items())
              + f"; {card}", flush=True)

    def serving(one: dict, run: dict) -> dict:
        one.update(sound_max=run["rel_max"], cache_rel=run["cache_rel"],
                   cache_leaf_rel=run["cache_leaf_rel"],
                   decode_rel=max(float(r.max()) for r in run["rel"]),
                   ms=run["ms"], plain_ms=run["plain_ms"],
                   faults=run["faults"])
        if "prefill_rel" in run:
            one["prefill_rel"] = float(run["prefill_rel"].max())
        return one

    for seed in args.seeds:
        if args.only in (None, "encdec"):
            cfg = get_config(cs.ENCDEC_ARCH)
            params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
                seed), device=dev)
            for sizes in cs.ENCDEC_MESHES:
                mesh, where = cs._split_mesh(sizes, ("data", "model"))
                run = cs.mesh_serving_steps(
                    dev, cfg, params, mesh, prefill=cs.ENCDEC_PREFILL,
                    decode=cs.ENCDEC_DECODE, steps=cs.ENCDEC_DECODE_STEPS,
                    seed=seed, faults=cs.ENCDEC_FAULTS.get(tuple(sizes), ()),
                    plant=lambda name: cs.planted_lever_fault(name, cfg,
                                                              sizes[1]))
                one = serving({"seed": seed, "group": "encdec",
                               "case": cs.ENCDEC_ARCH, "mesh": list(sizes),
                               "devices": where}, run)
                keep(one, f"seed {seed} {cs.ENCDEC_ARCH} over {sizes}: sound "
                     f"at most {one['sound_max']:.4e} (prefill "
                     f"{one['prefill_rel']:.3e}, decode "
                     f"{one['decode_rel']:.3e}, caches "
                     f"{one['cache_rel']:.3e})")
                del run
            del params
            torch.cuda.empty_cache()
        if args.only in (None, "train"):
            rows, seq, frames, n_steps = cs.ENCDEC_TRAIN
            cfg = get_config(cs.ENCDEC_ARCH).replace(
                n_layers=cs.ENCDEC_TRAIN_LAYERS,
                n_encoder_layers=cs.ENCDEC_TRAIN_LAYERS,
                param_dtype=cs.ENCDEC_TRAIN_DTYPE)
            params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
                seed + 1), device=dev)
            batches = cs._partition_batches(cfg, dev, rows, seq, n_steps,
                                            seed + 1, frames=frames)
            mesh, where = cs._split_mesh((2, 2), ("data", "model"))
            run = cs.partition_train_steps(
                dev, cfg, params, mesh, n_mb=2, batches=batches,
                opt_kw=cs.ENCDEC_TRAIN_OPT, faults=cs.ENCDEC_TRAIN_FAULTS)
            one = {"seed": seed, "group": "encdec", "case": "train",
                   "layers": cfg.n_layers, "mesh": [2, 2], "devices": where,
                   "sound_max": run["rel_max"], "loss_rel": run["loss_rel"],
                   "grad_norm_rel": run["grad_norm_rel"],
                   "mu_rel": run["mu_rel"], "faults": run["faults"],
                   "ms": run["ms"], "plain_ms": run["plain_ms"]}
            keep(one, f"seed {seed} {cs.ENCDEC_ARCH} train over (2, 2): "
                 f"sound at most {one['sound_max']:.4e} (loss "
                 f"{max(run['loss_rel']):.3e}, grad_norm "
                 f"{max(run['grad_norm_rel']):.3e}, mu "
                 f"{max(run['mu_rel']):.3e})")
            del run, params, batches
            torch.cuda.empty_cache()
        if args.only in (None, "int8"):
            loaded = {}
            for (label, arch, layers, change, quant, sizes, pre,
                 faults) in cs.INT8_CASES:
                full = get_config(arch)
                cfg = full.replace(n_layers=layers or full.n_layers,
                                   **change)
                key = (arch, cfg.n_layers)
                if key not in loaded:
                    loaded.clear()
                    torch.cuda.empty_cache()
                    loaded[key] = init_lm(cfg, generator=torch.Generator(
                        dev).manual_seed(seed + 2), device=dev)
                params = quantize_tree(loaded[key]) if quant else loaded[key]
                mesh, where = cs._split_mesh(sizes, ("data", "model"))
                run = cs.mesh_serving_steps(
                    dev, cfg, params, mesh,
                    prefill=cs.INT8_PREFILL if pre else None,
                    decode=cs.INT8_DECODE, steps=cs.INT8_STEPS,
                    seed=seed + 2, faults=faults,
                    plant=lambda name: cs.planted_lever_fault(name, cfg,
                                                              sizes[1]))
                one = serving({"seed": seed, "group": "int8",
                               "case": f"{arch} {label}",
                               "mesh": list(sizes), "devices": where}, run)
                keep(one, f"seed {seed} {arch} {label} over {sizes}: sound "
                     f"at most {one['sound_max']:.4e} (decode "
                     f"{one['decode_rel']:.3e}, caches "
                     + ", ".join(f"{k} {v:.3e}" for k, v in
                                 run["cache_leaf_rel"].items()) + ")")
                del run, params
            loaded.clear()
            torch.cuda.empty_cache()
    out = {"card": card, "readings": readings}
    for group in ("encdec", "int8"):
        mine = [r for r in readings if r["group"] == group]
        if not mine:
            continue
        faults = [v for r in mine for v in r["faults"].values()]
        out[group] = {
            "sound_max": float(np.max([r["sound_max"] for r in mine])),
            "fault_min": float(np.min(faults)) if faults else None}
        print(f"{group} over {len(args.seeds)} seeds: sound at most "
              f"{out[group]['sound_max']:.4e}, the faults at least "
              f"{out[group]['fault_min']}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
