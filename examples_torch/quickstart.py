"""Quickstart: the SIMDRAM three-step framework in 60 seconds, on the card.

The port's counterpart of ``examples/quickstart.py``.  Builds an
operation, synthesizes MAJ/NOT, maps it to DRAM rows, executes it on
every backend (faithful subarray sim / control-unit replay on K5 /
bit-plane circuit on K3 / the hand-kernel fast path K1 -> K3 -> K2), and
prints the cost model's verdict.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.costmodel import decide
from repro_torch.core.energy import energy_per_elem_pj
from repro_torch.core.isa import SimdramDevice, compile_op
from repro_torch.core.timing import DDR4, throughput_gops, uprogram_latency_s
from repro_torch.kernels.build import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    out = {"results": {}, "modeled": {}}

    # ---- Step 1+2: compile 8-bit addition (MAJ/NOT → μProgram) -----------
    spec, uprog = compile_op("addition", 8, "mig")
    print(f"addition/8b μProgram: {uprog.n_aap} AAPs + {uprog.n_ap} APs "
          f"({uprog.n_activations} row activations, "
          f"{uprog.n_scratch} scratch rows)")
    print(f"  latency {uprogram_latency_s(uprog)*1e9:.0f} ns for "
          f"{DDR4.simd_lanes:,} lanes  →  "
          f"{throughput_gops(uprog):,.0f} GOps/s, "
          f"{energy_per_elem_pj(uprog):.2f} pJ/op")
    print("  first 8 commands:")
    for cmd in uprog.commands[:8]:
        print(f"    {cmd!r}")
    out["modeled"].update(
        n_aap=uprog.n_aap, n_ap=uprog.n_ap,
        n_activations=uprog.n_activations, n_scratch=uprog.n_scratch,
        latency_s=uprogram_latency_s(uprog), gops=throughput_gops(uprog),
        pj_per_op=energy_per_elem_pj(uprog),
        first_commands=[repr(c) for c in uprog.commands[:8]])

    # ---- the Ambit baseline runs the AND/OR/NOT program --------------------
    _, up_ambit = compile_op("addition", 8, "aig")
    print(f"  Ambit equivalent: {up_ambit.n_activations} activations "
          f"(SIMDRAM is {up_ambit.n_activations/uprog.n_activations:.2f}× "
          f"cheaper — paper §2)")
    out["modeled"]["ambit_activations"] = up_ambit.n_activations

    # ---- Step 3: execute on every backend ------------------------------------
    # the port adds a fourth line: "cuda", the hand-kernel fast path
    # (K1 -> K3 -> K2) that stands where the reference's "pallas" stands
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=1000).astype(np.int64)
    y = rng.integers(0, 256, size=1000).astype(np.int64)
    for backend in ("subarray", "interp", "bitplane", "cuda"):
        dev = SimdramDevice(backend=backend, device=device)
        got = np.asarray(dev.bbop("addition", x, y, n_bits=8))
        assert np.array_equal(got.astype(np.int64), (x + y) % 256)
        print(f"  backend {backend:9s}: OK "
              f"(accounted latency {dev.totals()['latency_s']*1e6:.1f} μs)")
        out["results"][backend] = got.astype(np.int64).tolist()
        out["modeled"][f"{backend}_totals"] = dev.totals()

    # ---- §4 system integration: should we offload? --------------------------
    for n in (1 << 12, 1 << 24):
        plan = decide("addition", 8, n)
        print(f"  offload {n:>10,} elems? {'YES' if plan.offload else 'no '} "
              f"(host {plan.host_s*1e3:.2f} ms vs PuM {plan.pum_total_s*1e3:.2f} ms"
              f" incl. transpose {plan.pum_transpose_s*1e3:.2f} ms)")
        out["modeled"][f"offload_{n}"] = [plan.offload, plan.host_s,
                                          plan.pum_total_s,
                                          plan.pum_transpose_s]

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
