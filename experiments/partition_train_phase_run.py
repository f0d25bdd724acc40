"""Run ``chip_smoke.py``'s phase 18 (the train step partitioned over a
device mesh) alone on one card.

    PYTHONPATH=src python experiments/partition_train_phase_run.py \\
        [--json PATH]

Builds the kernels, runs phase 16 first (18c holds its drill's losses
against 16b's), then ``chip_smoke.partition_train_phase`` exactly as the
smoke does: internvl2-1b's partitioned train steps (18a), yi-6b's PuM
MLP in a partitioned prefill and train step on K3 (18b) and the elastic
drill through ``partitioned_step`` (18c).  Prints the phases' lines,
phase 18's wall and its record as JSON (or writes it to ``--json``).
Needs a CUDA card.
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
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("partition_train_phase_run: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "experiments"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(f"[0] {card}", flush=True)
    record = {"card": card}
    kern = {name: {"agreement": {}} for name in
            ("h2v", "v2h", "circuit", "replay")}
    dev = torch.device("cuda")
    chip_smoke.phase("16")
    chip_smoke.mesh_lm_phase(dev, record, kern)
    chip_smoke.release_device_memory("18")
    t0 = time.perf_counter()
    chip_smoke.phase("18")
    counts = chip_smoke.partition_train_phase(dev, record, kern)
    record["phase_s"] = time.perf_counter() - t0
    record["launches"] = counts
    record["agreement"] = kern["circuit"]["agreement"]
    print(f"[18] phase 18 took {record['phase_s']:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB in 18b",
          flush=True)
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
