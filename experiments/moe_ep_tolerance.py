"""Read how far ``chip_smoke.py`` 16a's expert-parallel decode lies from
the grouped decode of the same tokens, over several seeds, to set its
tolerance ``MOE_EP_REL``.

    PYTHONPATH=src python experiments/moe_ep_tolerance.py \
        [--seeds 17 201 202 203 204 205] [--layers 24] [--json PATH]

For each seed, granite-moe-1b-a400m at its published widths in bf16
(``--layers`` of its 24 layers, weights from a seeded generator on the
card) serves the smoke's 4 prompts (drawn from the seed) greedily with
``moe_impl="ep"`` over a (1, 4) mesh of the visible cards or ``cuda:0``
repeated, the grouped decode of the same tokens in lockstep
(``chip_smoke.moe_ep_served``, under deterministic algorithms, without
the offload, which returns the logits it is given).  Each row of each step is read as max|ep -
grouped| over the grouped row's max|logit|; then once with each model
rank's partial dropped before the psum (the smoke's planted fault is
rank 3's).  Prints, per seed and over all, the largest sound reading and
the smallest of the faults' largest readings.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[17, 201, 202, 203, 204, 205])
    ap.add_argument("--layers", type=int, default=None,
                    help="layers kept (default: chip_smoke.MESH_LM_LAYERS)")
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    # the served runs use deterministic algorithms, as in the smoke
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("moe_ep_tolerance: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    layers = args.layers or cs.MESH_LM_LAYERS
    cfg = get_config(cs.MESH_LM_ARCH).replace(n_layers=layers)
    mesh, where = cs._split_mesh(cs.MESH_LM_MESH, ("data", "model"))
    seeds = []
    for seed in args.seeds:
        params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
        rng = np.random.default_rng(seed)
        prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
                   for n in cs.MESH_LM_PROMPTS]
        rel = cs.moe_ep_rel(cs.moe_ep_served(dev, cfg, params, mesh, prompts))
        faults = {r: float(cs.moe_ep_rel(cs.moe_ep_served(
            dev, cfg, params, mesh, prompts[:2], drop_rank=r)).max())
            for r in range(cs.MESH_LM_MESH[1])}
        one = {"seed": seed, "sound": rel.tolist(),
               "sound_max": float(rel.max()),
               "sound_median": float(np.median(rel)), "faults_max": faults,
               "fault_min": min(faults.values())}
        seeds.append(one)
        print(f"seed {seed}: ep against grouped {one['sound_max']:.4e} at "
              f"most (median {one['sound_median']:.4e}, {rel.size} rows); "
              f"a rank's partial dropped reads at most "
              + ", ".join(f"rank {r} {v:.4e}" for r, v in faults.items())
              + f"; {card}", flush=True)
        del params
        torch.cuda.empty_cache()
    out = {"card": card, "arch": cs.MESH_LM_ARCH, "layers": layers,
           "mesh": list(cs.MESH_LM_MESH), "devices": where, "seeds": seeds,
           "sound_max": max(s["sound_max"] for s in seeds),
           "fault_min": min(s["fault_min"] for s in seeds)}
    print(f"over {len(seeds)} seeds: sound at most {out['sound_max']:.4e}, "
          f"the faults at least {out['fault_min']:.4e} (as fractions of each "
          f"row's max|logit|); {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
