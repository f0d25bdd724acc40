"""Run ``chip_smoke.py``'s phase 22 (layouts that do not divide over a
device mesh: SSD heads, head dim or conv channels over ``model``, and
microbatch rows over the data parts) alone on one card.

    PYTHONPATH=src python experiments/partition_uneven_phase_run.py \\
        [--json PATH]

Runs ``chip_smoke.partition_uneven_phase`` exactly as the smoke does:
hymba-1.5b's prefill and decode with its SSD, conv and attention whole
(22a) and mamba2-370m's train steps on uneven microbatch rows (22b),
each with its planted faults.  The phase launches none of the CUDA
kernels, so nothing is built.  Prints the phase's lines, its wall and
its record as JSON (or writes it to ``--json``).  Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the phase's record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("partition_uneven_phase_run: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "experiments"), str(ROOT)]
    import chip_smoke
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    record = {"card": card}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    chip_smoke.phase("22")
    chip_smoke.partition_uneven_phase(dev, record)
    chip_smoke.stop_phase_clock()
    record["phase_s"] = time.perf_counter() - t0
    print(f"[22] phase 22 took {record['phase_s']:.1f} s here", flush=True)
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
