"""Run ``chip_smoke.py``'s phase 14 (the examples of ``examples_torch/``)
alone on one card.

    PYTHONPATH=src python experiments/examples_phase_run.py [--json PATH] \
        [--only EXAMPLE ...]

Builds the kernels, then runs ``chip_smoke.examples_phase`` exactly as
the smoke does: every example in-process on the card, its launches
counted; a twin run of it in which each launch is held against the
plain version on its inputs; its returned dict against a run with
``--device cpu``.  Prints
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
    ap.add_argument("--only", nargs="+", metavar="EXAMPLE",
                    help="run only these examples (file names without .py)")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("examples_phase_run: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    if args.only:
        chip_smoke.EXAMPLE_KERNELS = {
            k: v for k, v in chip_smoke.EXAMPLE_KERNELS.items()
            if k in args.only}
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    record = {"card": card}
    kern = {k: {"agreement": {}} for k in chip_smoke.EXAMPLE_KERNELS_ALL}
    t0 = time.perf_counter()
    chip_smoke.phase("14")
    counts = chip_smoke.examples_phase(torch.device("cuda"), record, kern)
    record["phase_s"] = time.perf_counter() - t0
    record["launches"] = counts
    record["agreement"] = {k: v["agreement"] for k, v in kern.items()}
    print(f"[14] phase 14 took {record['phase_s']:.1f} s", flush=True)
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
