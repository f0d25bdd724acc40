"""Run ``chip_smoke.py``'s phase 16 (the LM side over a device mesh)
alone on one card.

    PYTHONPATH=src python experiments/mesh_phase_run.py [--json PATH]

Builds the kernels, then runs ``chip_smoke.mesh_lm_phase`` exactly as
the smoke does: granite-moe-1b-a400m served with ``moe_impl="ep"`` over
a (1, 4) mesh through ``PumServeOffload`` against the grouped decode
(16a), the elastic drill (16b) and ``gpipe`` with one stage a position
(16c), each mesh over the visible cards or ``cuda:0`` repeated.  Prints
the phase's lines, its wall, and its record as JSON (or writes it to
``--json``).  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the phase's record here")
    args = ap.parse_args()
    # 16b runs under deterministic algorithms (as chip_smoke.main sets it)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase_run: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    record = {"card": card}
    kern = {"replay": {"agreement": {}}}
    t0 = time.perf_counter()
    chip_smoke.phase("16")
    counts = chip_smoke.mesh_lm_phase(torch.device("cuda"), record, kern)
    record["phase_s"] = time.perf_counter() - t0
    record["launches"] = counts
    record["agreement"] = {k: v["agreement"] for k, v in kern.items()}
    print(f"[16] phase 16 took {record['phase_s']:.1f} s", flush=True)
    text = json.dumps(record, indent=1, default=str)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    else:
        print(text)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
