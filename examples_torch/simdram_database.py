"""Database analytics on SIMDRAM: BitWeaving scans + TPC-H Q6.

The port's counterpart of ``examples/simdram_database.py``: runs the
paper's database kernels end-to-end on the bit-plane backend (each
bbop's circuit one K3 launch on the card) and prints the modelled
in-DRAM throughput/energy against streaming-CPU and GPU baselines —
reproducing the §5 app-kernel comparison for the database workloads.

Run:  PYTHONPATH=src python examples_torch/simdram_database.py [--device cpu]
"""

import argparse

from repro_torch.apps import bitweaving, tpch
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.timing import (CPU_BASELINE, GPU_BASELINE,
                                     host_throughput_gops)
from repro_torch.kernels.build import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]

    n_rows = 262_144
    dev = SimdramDevice(backend="bitplane", style="mig", device=device)
    r = bitweaving.run(n_rows=n_rows, n_bits=12, device=dev)
    scans = 3  # eq/gt/ge bbops issued
    sd_gops = scans * n_rows / r["latency_s"] / 1e9
    cpu = host_throughput_gops(12, 2, 1, CPU_BASELINE)
    gpu = host_throughput_gops(12, 2, 1, GPU_BASELINE)
    print(f"BitWeaving scan over {n_rows:,} rows × 12b:")
    print(f"  SIMDRAM {sd_gops:8.1f} GOps/s   CPU {cpu:6.2f}   GPU {gpu:6.1f}"
          f"   (×{sd_gops/cpu:.0f} vs CPU, ×{sd_gops/gpu:.1f} vs GPU)")
    print(f"  energy accounted: {r['energy_mj']:.3f} mJ")

    dev2 = SimdramDevice(backend="bitplane", style="mig", device=device)
    q = tpch.run(n_rows=65_536, device=dev2)
    dev3 = SimdramDevice(backend="bitplane", style="aig", device=device)
    q_am = tpch.run(n_rows=65_536, device=dev3)
    print(f"TPC-H Q6-style query over {q['rows']:,} rows: "
          f"revenue={q['revenue']:,} ({q['selected']:,} rows selected)")
    print(f"  SIMDRAM latency {q['latency_s']*1e3:.2f} ms vs "
          f"Ambit {q_am['latency_s']*1e3:.2f} ms "
          f"(×{q_am['latency_s']/q['latency_s']:.2f})")

    after = kernel_counts()["launches"]
    return {"results": {"bitweaving": r, "tpch": q, "tpch_ambit": q_am},
            "modeled": {"sd_gops": sd_gops, "cpu_gops": cpu,
                        "gpu_gops": gpu,
                        "totals": [dev.totals(), dev2.totals(),
                                   dev3.totals()]},
            "launches": {k: after[k] - launches0[k] for k in after}}


if __name__ == "__main__":
    main()
