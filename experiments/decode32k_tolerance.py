"""Read how far ``chip_smoke.py`` 13b's card decode lies from the CPU's,
over several seeds and rows, to set its tolerance ``DECODE_REL``.

    PYTHONPATH=src python experiments/decode32k_tolerance.py \
        [--seeds 13 101 102 103 104 105] [--rows 0 1 31 32 63 64 126 127] \
        [--json PATH]

For each seed, ``chip_smoke.decode_cell`` builds internvl2-1b x
decode_32k whole on the card (batch 128 against a 32,768-slot bf16
cache, every layer) and runs one ``make_serve_step`` step; each row is
held against the port's CPU run of the same row in bf16 (the smoke's
comparison) and in float32 from the same values (bf16's own error), and
against the bf16 CPU run with its position one later (the smoke's
planted fault).  Prints, per seed and over all, the largest sound
reading and the smallest fault reading as fractions of each row's
max|value|.  Needs a CUDA card.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[13, 101, 102, 103, 104, 105])
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[0, 1, 31, 32, 63, 64, 126, 127])
    ap.add_argument("--json", help="write the readings here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode32k_tolerance: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.launch.mesh import make_host_mesh

    card = chip_smoke.nvidia_smi("name,power.limit")
    mesh = make_host_mesh()
    seeds = []
    for seed in args.seeds:
        run = chip_smoke.decode_cell(torch.device("cuda"), mesh, seed,
                                     tuple(args.rows), fp32=True)
        one = {"seed": seed, "positions": run["pos_rows"].tolist(),
               "bf16": {k: v.tolist() for k, v in run["rel"].items()},
               "fp32": {k: v.tolist() for k, v in run["rel_fp32"].items()},
               "fault": run["rel_fault"].tolist(), "cpu_s": run["cpu_s"]}
        one["sound_max"] = max(max(v) for v in one["bf16"].values())
        one["fp32_max"] = max(max(v) for v in one["fp32"].values())
        one["fault_min"] = min(one["fault"])
        seeds.append(one)
        print(f"seed {seed}: card vs CPU bf16 {one['sound_max']:.4e}, card vs"
              f" CPU float32 {one['fp32_max']:.4e}, position off by one "
              f"{one['fault_min']:.4e} or more (rows {args.rows} at "
              f"{one['positions']})", flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"card": card, "rows": args.rows,
               "sound_max": max(s["sound_max"] for s in seeds),
               "fp32_max": max(s["fp32_max"] for s in seeds),
               "fault_min": min(s["fault_min"] for s in seeds),
               "seeds": seeds}
    print(f"over {len(seeds)} seeds x {len(args.rows)} rows: sound at most "
          f"{summary['sound_max']:.4e} (bf16 CPU), {summary['fp32_max']:.4e} "
          f"(float32 CPU); fault at least {summary['fault_min']:.4e}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
