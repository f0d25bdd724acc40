"""§4 system-integration demo: the offload decision + transposition unit.

The port's counterpart of ``examples/pum_offload_demo.py``.  Sweeps
workload sizes and operand residency to show WHEN in-DRAM execution wins
over the host — the paper's horizontal/vertical coexistence story — then
demonstrates the LM integration flag (cfg.pum="bitplane") routing a
quantized ReLU through a real bbop: one K3 launch a layer on the card.

Run:  PYTHONPATH=src python examples_torch/pum_offload_demo.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.costmodel import decide
from repro_torch.core.transpose import transpose_cost_s
from repro_torch.kernels.build import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import init_lm, lm_forward


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
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {"sweep": []}}

    print("op=addition/8b — host vs PuM (times in ms):")
    print(f"{'elements':>12} {'host':>8} {'PuM+trsp':>9} {'PuM(warm)':>9}  verdict")
    for logn in (10, 14, 18, 22, 26):
        n = 1 << logn
        cold = decide("addition", 8, n)
        warm = decide("addition", 8, n, operands_vertical=2,
                      result_stays_vertical=True)
        v = "OFFLOAD" if cold.offload else ("warm-only" if warm.offload else "host")
        print(f"{n:12,} {cold.host_s*1e3:8.3f} {cold.pum_total_s*1e3:9.3f} "
              f"{warm.pum_total_s*1e3:9.3f}  {v}")
        out["modeled"]["sweep"].append([n, cold.host_s, cold.pum_total_s,
                                        warm.pum_total_s, v])

    print("\ntransposition-unit cost (1M × 8b):",
          f"{transpose_cost_s(1<<20, 8)*1e6:.1f} μs per direction")
    out["modeled"]["transpose_s"] = transpose_cost_s(1 << 20, 8)

    # LM integration: quantized ReLU through the SIMDRAM bit-plane backend
    cfg = smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", param_dtype="float32")
    if params is None:
        params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    toks = torch.zeros((1, 8), dtype=torch.int32, device=device)
    feats = torch.zeros((1, 4, cfg.d_model), dtype=torch.float32,
                        device=device)
    with torch.no_grad():
        logits, _ = lm_forward(params, toks, cfg, encoder_feats=feats)
    # the shape as a tuple, as the reference prints a JAX array's
    print(f"\nLM with pum=bitplane: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")
    out["results"]["finite"] = bool(torch.isfinite(logits).all())
    out["results"]["shape"] = list(logits.shape)
    out["lm"] = {"logits": logits.to(torch.float32).cpu().numpy()}

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
