"""Serving example: continuous-batching greedy decoding over cache slots.

The port's counterpart of ``examples/serve_llm.py``.  Spins up the
Server with a small dense model, submits a burst of requests with
different prompt lengths, and shows slot reuse + EOS handling.  (Weights
are random — outputs are arbitrary tokens; the point is the serving
machinery: KV slots, ring positions, admission.)

Run:  PYTHONPATH=src python examples_torch/serve_llm.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.build import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import init_lm
from repro_torch.train.serve import Request, Server


def main(argv=None, params=None):
    """``params``: the LM's weights (a tree of tensors, e.g. another
    package's init carried across with ``params_from_numpy``); by default
    ``init_lm`` draws them from a CPU generator seeded with 0, so the card
    and the CPU run the same weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config("yi-6b").replace(n_layers=2)
    if params is None:
        params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    server = Server(cfg, params, batch_slots=4, max_len=64, device=device)
    logits = _record_logits(server)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(2, cfg.vocab_size, size=n)),
                    max_new=8) for n in (3, 7, 5, 2, 9, 4)]
    for r in reqs:
        server.submit(r)

    t0 = time.time()
    server.run(max_steps=256)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    # the reference says "on CPU"; the port names the device it ran on
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"served {done}/{len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s on {where})")
    for i, r in enumerate(reqs):
        print(f"  req{i}: prompt[{len(r.prompt)}] -> {r.out}")
    assert all(r.done for r in reqs)
    return {"results": {"done": done, "tokens": toks},
            "lm": {"tokens": [list(r.out) for r in reqs], "logits": logits},
            "measured": {"wall_s": dt}}


def _record_logits(server):
    """Keep each decode step's logits (float32, on the host) as the
    server computes them, for holding two runs' tokens under a margin
    rule: a list the server's steps append to."""
    logits, step_fn = [], server.step_fn

    def recording(*args):
        lg, caches = step_fn(*args)
        logits.append(lg.to(torch.float32).cpu().numpy())
        return lg, caches

    server.step_fn = recording
    return logits


if __name__ == "__main__":
    main()
