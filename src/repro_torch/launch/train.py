"""Training launcher: end-to-end loop with checkpointing + fault tolerance
(counterpart of :mod:`repro.launch.train`).

    python -m repro_torch.launch.train --arch internvl2-1b --steps 20 \
        [--full] [--device cpu] [--ckpt_dir DIR] [--log PATH]

Features exercised here:

  - data pipeline with prefetch + deterministic restart,
  - microbatch accumulation + remat (``make_train_step``'s default),
  - atomic checkpoints every ``ckpt_every`` steps + auto-resume from
    ``ckpt_dir`` and ``ckpt_dir + "_opt"``,
  - straggler policy hooks + heartbeat monitor (simulated on one host),
  - loss logging to ``log_path`` (JSON lines).

It runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from ..configs import ARCHS, get_config, smoke_config
from ..kernels.build import resolve_device
from ..models.transformer import init_lm
from ..train import checkpoint as ckpt
from ..train import optimizer as opt
from ..train.data import DataConfig, batch_iterator
from ..train.fault_tolerance import HeartbeatMonitor, StragglerPolicy
from ..train.train_loop import make_train_step


def train(
    arch: str = "internvl2-1b",
    smoke: bool = True,
    steps: int = 20,
    seq_len: int = 128,
    batch: int = 8,
    n_microbatches: int = 1,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 10,
    lr: float = 3e-4,
    log_path: Optional[str] = None,
    seed: int = 0,
    device="cuda",
):
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                           total_steps=steps)
    dc = DataConfig(seq_len=seq_len, global_batch=batch, seed=seed)

    params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(seed),
                     device=dev)
    opt_state = opt.init(params)
    start_step = 0

    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            params = ckpt.restore(ckpt_dir, last, params, device=dev)
            opt_state = ckpt.restore(ckpt_dir + "_opt", last, opt_state,
                                     device=dev)
            start_step = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, ocfg, n_microbatches=n_microbatches)
    hb = HeartbeatMonitor(n_hosts=1)
    straggler = StragglerPolicy()
    logs = []

    it = batch_iterator(cfg, dc, start_step=start_step)
    t_all = time.time()
    for step in range(start_step, steps):
        b = next(it)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        hb.beat(0)
        straggler.record(0, dt)
        logs.append({"step": step + 1, "loss": loss, "sec": round(dt, 3),
                     "grad_norm": float(metrics["grad_norm"])})
        if (step + 1) % max(1, steps // 10) == 0 or step == start_step:
            print(f"step {step+1:5d}  loss {loss:.4f}  {dt:.2f}s/step")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, params)
            ckpt.save(ckpt_dir + "_opt", step + 1, opt_state)
    wall = time.time() - t_all
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "w") as f:
            for rec in logs:
                f.write(json.dumps(rec) + "\n")
    return {"final_loss": logs[-1]["loss"] if logs else None,
            "first_loss": logs[0]["loss"] if logs else None,
            "wall_s": wall, "logs": logs, "params": params}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-1b", choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true", help="full (not smoke) config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    out = train(arch=args.arch, smoke=not args.full, steps=args.steps,
                seq_len=args.seq_len, batch=args.batch,
                n_microbatches=args.microbatches,
                ckpt_dir=args.ckpt_dir, log_path=args.log,
                device=args.device)
    print(f"done: loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"in {out['wall_s']:.0f}s")


if __name__ == "__main__":
    main()
