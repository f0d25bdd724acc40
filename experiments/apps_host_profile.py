"""Where the host's time goes in one warm TPC-H Q6 run of the port.

    PYTHONPATH=src python experiments/apps_host_profile.py \
        [--rows 6001215] [--rungs bitplane bank channel] [--top 22]

Runs ``repro_torch.apps.tpch.run`` over ``--rows`` lineitem rows (default:
the 6,001,215 of TPC-H scale factor 1) on
``DramConfig(n_banks=16, subarrays_per_bank=2, n_chips=4)``, the
configuration of ``chip_smoke.py`` phases 8b and 8c, on each rung: once
to compile the μPrograms and fill the table cache, then once under
``cProfile``, and prints each rung's wall and its functions by own time
and by cumulative time.  Needs a CUDA card (the kernels build on first
use); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

TPCH_SF1_ROWS = 6_001_215


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=TPCH_SF1_ROWS)
    p.add_argument("--rungs", nargs="+",
                   default=["bitplane", "bank", "channel"])
    p.add_argument("--top", type=int, default=22)
    args = p.parse_args()

    import torch

    from repro_torch.apps import tpch
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DramConfig
    from repro_torch.kernels import build

    build.build_all()
    cfg = DramConfig(n_banks=16, subarrays_per_bank=2, n_chips=4)

    def once(backend: str) -> None:
        tpch.run(n_rows=args.rows, device=SimdramDevice(
            backend=backend, cfg=cfg, device="cuda"))
        torch.cuda.synchronize()

    for backend in args.rungs:
        once(backend)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        once(backend)
        prof.disable()
        print(f"== {backend}: {time.perf_counter() - t0:.3f} s under "
              f"cProfile, {args.rows} rows", flush=True)
        for order in ("tottime", "cumulative"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(order).print_stats(
                args.top)
            print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
