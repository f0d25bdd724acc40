"""Run ``chip_smoke.py``'s phase 15 (the ladder split across devices)
alone on one card.

    PYTHONPATH=src python experiments/split_phase_run.py [--json PATH]

Builds the kernels, then runs ``chip_smoke.split_phase`` exactly as the
smoke does: the chip, channel and rank and the chip's and a channel's
fault wrappers split over meshes of the visible cards (or ``cuda:0``
repeated), each against the unsplit executor, with a twin run holding
every slab launch against the plain version.  Prints the phase's lines,
its wall, and its record as JSON (or writes it to ``--json``).  Needs a
CUDA card.
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
        print("split_phase_run: torch finds no CUDA device", file=sys.stderr)
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
    kern = {k: {"agreement": {}} for k in ("replay", "faulty_replay")}
    t0 = time.perf_counter()
    chip_smoke.phase("15")
    counts = chip_smoke.split_phase(torch.device("cuda"), record, kern)
    record["phase_s"] = time.perf_counter() - t0
    record["launches"] = counts
    record["agreement"] = {k: v["agreement"] for k, v in kern.items()}
    print(f"[15] phase 15 took {record['phase_s']:.1f} s", flush=True)
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
