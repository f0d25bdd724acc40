"""Run ``chip_smoke.py``'s phase 17 (the LM's serving steps partitioned
over a device mesh) alone on one card.

    PYTHONPATH=src python experiments/partition_phase_run.py [--json PATH]

Runs ``chip_smoke.partition_phase`` exactly as the smoke does, under the
cuBLAS workspace the smoke sets: yi-6b's prefill and decode (17a) and
internvl2-1b's decode (17b) partitioned over meshes of the visible cards
or ``cuda:0`` repeated against the unpartitioned steps, and the dry
run's fields from position 0's program (17c).  Prints the phase's lines,
its wall, and its record as JSON (or writes it to ``--json``).  Needs a
CUDA card.
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
    # phase 17 runs under deterministic algorithms (as chip_smoke.main sets)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("partition_phase_run: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    record = {"card": card}
    t0 = time.perf_counter()
    chip_smoke.phase("17")
    chip_smoke.partition_phase(torch.device("cuda"), record)
    record["phase_s"] = time.perf_counter() - t0
    print(f"[17] phase 17 took {record['phase_s']:.1f} s", flush=True)
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
