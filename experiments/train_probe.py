"""Where a full-width train step's and a checkpoint's time goes, on one
card.

    PYTHONPATH=src python experiments/train_probe.py [--json PATH]

internvl2-1b at its published width (bf16 params, fp32 moments), the
batch of ``chip_smoke.py`` 12b (8 x (256 + 512) positions, two
microbatches):

1. one train step under each ``remat`` mode ("dots", the default,
   "full" and "none"): host wall of two warm steps (after a synchronize),
   ``torch.cuda.max_memory_allocated`` from a fresh peak, and one
   profiled step's card busy time, idle share and device time by kernel;
   and the host time of "dots" with the card's work taken out
   (``torch.profiler``'s CPU self time by op, the top entries);
2. a checkpoint of the optimizer state (5.04 GB) taken apart: the copy
   to the host, ``tobytes``, sha1 over every leaf, ``np.savez``, and
   reading back (``np.load`` of every leaf, sha1, the copy to the card),
   beside ``checkpoint.save`` and ``restore`` end to end.

Needs a CUDA card; writes its checkpoints under ``build/train_probe/``
and deletes them.
"""

import argparse
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the record here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.params import flatten
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step

    dev = torch.device("cuda")
    card = cs.nvidia_smi("name,power.limit")
    cfg = get_config(cs.TRAIN_ARCH)
    params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0),
                     device=dev)
    batch = cs._train_batches(cfg, dev, 1, (cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                                            0))[0]
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=6)
    record = {"card": card, "remat": {}}

    for remat in ("dots", "full", "none"):
        step = make_train_step(cfg, ocfg, n_microbatches=cs.TRAIN_MICRO,
                               remat=remat)
        held = [params, opt.init(params)]

        def one():
            held[:] = step(held[0], held[1], batch)[:2]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one()
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            t = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        prof = cs.device_breakdown(one)
        row = {"wall_s": walls, "max_memory_allocated": peak,
               "profiled": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                 "idle_share")},
               "device_ms_top": dict(list(prof["device_ms"].items())[:6])}
        if remat == "dots":
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as p:
                one()
                torch.cuda.synchronize()
            ops = sorted(p.key_averages(), key=lambda e: -e.self_cpu_time_total)
            row["host_self_ms_top"] = {e.key: e.self_cpu_time_total / 1e3
                                       for e in ops[:12]}
            row["host_ops"] = sum(e.count for e in p.key_averages())
        record["remat"][remat] = row
        print(f"[remat {remat}] warm steps {fmt(walls)} s, peak "
              f"{peak / 2**30:.2f} GiB, profiled wall {prof['wall_ms']:.1f} "
              f"ms, card busy {prof['device_busy_ms']:.1f} ms, idle "
              f"{prof['idle_share']:.4f}; {card}", flush=True)
        state = held[1]
        del held

    # -- a checkpoint of the optimizer state, taken apart ------------------
    d = ROOT / "build" / "train_probe"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    leaves = flatten(state)
    parts = {}
    t = time.perf_counter()
    host = [x.detach().cpu() for x in leaves]
    parts["d2h_s"] = time.perf_counter() - t
    arrays = [h.numpy() for h in host]
    t = time.perf_counter()
    for a in arrays:
        a.tobytes()
    parts["tobytes_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for a in arrays:
        hashlib.sha1(a.tobytes()).hexdigest()
    parts["sha1_tobytes_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for a in arrays:
        hashlib.sha1(memoryview(np.ascontiguousarray(a)).cast("B"))
    parts["sha1_view_s"] = time.perf_counter() - t
    t = time.perf_counter()
    np.savez(d / "parts.npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    parts["savez_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with np.load(d / "parts.npz") as data:
        back = [data[f"leaf_{i}"] for i in range(len(arrays))]
    parts["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for a in back:
        torch.from_numpy(a).to(dev)
    torch.cuda.synchronize()
    parts["h2d_s"] = time.perf_counter() - t
    parts["bytes"] = sum(a.nbytes for a in arrays)
    t = time.perf_counter()
    ckpt.save(str(d / "ck"), 1, state)
    parts["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ckpt.restore(str(d / "ck"), 1, state, device=dev)
    torch.cuda.synchronize()
    parts["restore_s"] = time.perf_counter() - t
    parts["cpus"] = os.cpu_count()
    shutil.rmtree(d, ignore_errors=True)
    record["checkpoint_opt_state"] = parts
    print("[checkpoint] " + json.dumps({k: round(v, 3) if isinstance(v, float)
                                        else v for k, v in parts.items()})
          + f"; {card}", flush=True)
    text = json.dumps(record, indent=1)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    print(json.dumps(record["remat"]["dots"].get("host_self_ms_top")))
    print(card)
    return 0


def fmt(xs):
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


if __name__ == "__main__":
    sys.exit(main())
