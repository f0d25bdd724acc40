"""Run ``chip_smoke.py``'s phase 12 (the trainer) alone on one card.

    PYTHONPATH=src python experiments/train_phase_run.py [--json PATH]

Builds the kernels, then runs ``chip_smoke.train_phase`` exactly as the
smoke does (12a every arch's train steps against the CPU and the PuM MLP
on K3; 12b internvl2-1b at full width, checkpointed and resumed), and
prints the phase's record as JSON (or writes it to ``--json``).  Needs a
CUDA card.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the phase's record here")
    args = ap.parse_args()
    # the fixed cuBLAS workspace 12b's bit-exact resume needs, set before
    # torch starts CUDA (as chip_smoke.main does)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("train_phase_run: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    card = chip_smoke.nvidia_smi("name,power.limit")
    record = {"card": card}
    kern = {"circuit": {"agreement": {}}}
    counts = chip_smoke.train_phase(torch.device("cuda"), record, kern)
    record.update(launches=counts, agreement=kern["circuit"]["agreement"])
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
