"""End-to-end driver: train a ~100M-param LM for a few hundred steps.

The port's counterpart of ``examples/train_lm.py``: a dense GQA model
(d=640, 10 layers, ~100M params with embeddings) on the synthetic
pipeline, with checkpointing every 50 steps and automatic resume,
through ``repro_torch.launch.train``'s ``train`` on the card.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]

Checkpoints go to ``--ckpt`` and the loss log to
``experiments/train_log_100m.jsonl``, both relative to the working
directory, as in the reference.
"""

import argparse

import torch

import repro_torch.launch.train as T
from repro_torch.kernels.build import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import init_lm


CONFIG_100M = ModelConfig(
    name="dense-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=2048, vocab_size=32000, head_dim=64, act="swiglu",
)


def main(argv=None, params=None):
    """``params``: the initial weights (a tree of tensors, e.g. another
    package's init carried across with ``params_from_numpy``); by default
    ``init_lm`` draws them from a CPU generator seeded with 0, so the card
    and the CPU start from the same weights.  A checkpoint found under
    ``--ckpt`` still wins, as in the reference."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default="experiments/ckpt_100m")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    print(f"training {CONFIG_100M.name}: "
          f"{CONFIG_100M.param_count()/1e6:.0f}M params, "
          f"{args.steps} steps @ seq {args.seq_len} × batch {args.batch}")

    if params is None:
        params = init_lm(CONFIG_100M,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")

    # route through the generic driver with a custom config and weights
    orig = T.get_config, T.smoke_config, T.init_lm
    T.get_config = lambda name: CONFIG_100M
    T.smoke_config = lambda name: CONFIG_100M
    T.init_lm = lambda cfg, generator=None, device=None: tree_map(
        lambda t: t.to(device), params)
    try:
        out = train(arch="dense-100m", smoke=False, steps=args.steps,
                    seq_len=args.seq_len, batch=args.batch,
                    ckpt_dir=args.ckpt, ckpt_every=50,
                    log_path="experiments/train_log_100m.jsonl",
                    device=device)
    finally:
        T.get_config, T.smoke_config, T.init_lm = orig
    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"({out['wall_s']:.0f}s total)")
    return {"results": {"steps": len(out["logs"])},
            "lm": {"losses": [r["loss"] for r in out["logs"]],
                   "grad_norms": [r["grad_norm"] for r in out["logs"]]},
            "measured": {"wall_s": out["wall_s"]}}


if __name__ == "__main__":
    main()
