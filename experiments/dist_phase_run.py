"""Run ``chip_smoke.py``'s phase 13 (launch and distributed) alone on one
card.

    PYTHONPATH=src python experiments/dist_phase_run.py [--json PATH]

Runs ``chip_smoke.distributed_phase`` exactly as the smoke does (13a the
dry run of internvl2-1b x decode_32k on meta; 13b that cell whole on the
card against a CPU run of three rows; 13c ``gpipe`` at full width
against the sequential blocks; 13d the collectives over a one-rank NCCL
group) and prints the phase's record as JSON (or writes it to
``--json``).  The phase launches none of the port's kernels, so nothing
is built.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the phase's record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dist_phase_run: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    card = chip_smoke.nvidia_smi("name,power.limit")
    record = {"card": card}
    chip_smoke.distributed_phase(torch.device("cuda"), record)
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
