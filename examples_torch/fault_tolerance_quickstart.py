"""Fault-injected execution: detect, retry, repack, degrade — end to end.

The port's counterpart of ``examples/fault_tolerance_quickstart.py``,
whose module-scope walk-through is ``main()`` here.

Run:  PYTHONPATH=src python examples_torch/fault_tolerance_quickstart.py [--device cpu]

Walks the whole fault-tolerance flow on one bank and one chip:

  - a ``FaultModel`` derives its per-activation flip probability from
    the reliability Monte-Carlo (σ → ``tra_failure_breakdown``) and
    injects flips INSIDE the replay kernel (K6 on the card) — the fault
    path replays the same command tables as the clean one (K5);
  - spare-lane modular redundancy (strided replicas + majority vote at
    unpack) detects corrupted lanes; bounded retry re-replays with
    fresh fault draws until every lane decides;
  - a dead subarray defeats retry, gets blacklisted, and the wave
    packer repacks around it — the dispatch still returns bit-exact
    results, just on fewer subarrays;
  - a hopeless device exhausts its redispatch budget and raises
    ``FaultExhaustedError`` — which the serving path catches to fall
    back to the host oracle;
  - a disabled model is strictly free: same launches, same latency.

The flips come from the port's Philox4x32-10 draws, not from
``jax.random``: section 1 and section 3 agree with the reference in
distribution only.  Dead subarrays are drawn with numpy in both, so
section 2 names the same subarrays.
"""

import argparse

import numpy as np

from repro_torch.core.bank import Bank, BbopInstr, Ref
from repro_torch.core.chip import SimdramChip
from repro_torch.core.control_unit import kernel_counts
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.kernels.build import resolve_device

LANES = 256
MEASURED = ("wall_s", "pack_wall_s")


def _values(results):
    return [np.asarray(r).astype(np.int64).tolist() for r in results]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    launches0 = kernel_counts()["launches"]
    # "results" and "modeled" are deterministic; "drawn" depends on the
    # flips drawn (the same Philox stream on the card and on the CPU)
    out = {"results": {}, "modeled": {}, "drawn": {}}
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, LANES).astype(np.uint64)
    b = rng.integers(0, 256, LANES).astype(np.uint64)
    queue = lambda: [
        BbopInstr("addition", (a, b), 8),
        BbopInstr("multiplication", (Ref(0), b), 8),
        BbopInstr("greater", (a, b), 8),
    ]

    clean = Bank(n_subarrays=4, device=device).dispatch(queue())
    out["results"]["clean"] = _values(clean)

    # -- 1. paper-rate flips, one spare lane --------------------------------
    model = FaultModel(sigma=0.15, tech_node="17nm", spare_lanes=1, seed=1)
    print(f"σ=0.15 @ 17nm → p_flip = {model.flip_probability():.2e} "
          f"(replicas per lane: {model.replicas})")
    bank = Bank(n_subarrays=4, fault=model, device=device)
    got = bank.dispatch(queue())
    exact = all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(clean, got))
    print(f"bit-exact after detection/retry: {exact}")
    print(f"fault stats: {bank.stats.faults.as_dict()}")
    print(f"modeled latency {bank.stats.latency_s * 1e6:.1f} us "
          f"+ fault overhead {bank.stats.faults.overhead_s * 1e6:.3f} us\n")
    out["modeled"]["p_flip"] = model.flip_probability()
    out["drawn"]["bank"] = {"exact": exact, "results": _values(got),
                            "faults": bank.stats.faults.as_dict(),
                            "latency_s": bank.stats.latency_s}

    # -- 2. dead subarray: blacklist + repack -------------------------------
    model = FaultModel(p_flip=0.0, dead_unit_rate=0.4, spare_lanes=1, seed=11)
    bank = Bank(n_subarrays=4, fault=model, device=device)
    dead = list(np.where(bank._fault_rt.dead)[0])
    print(f"dead subarrays drawn: {dead}")
    got = bank.dispatch(queue())
    exact = all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(clean, got))
    print(f"bit-exact after blacklist+repack: {exact} "
          f"(blacklisted: {sorted(bank._blacklist)}, "
          f"redispatches: {bank.stats.faults.redispatches})\n")
    out["results"]["dead"] = _values(got)
    out["modeled"]["dead"] = {
        "dead": [int(d) for d in dead], "exact": exact,
        "blacklist": [int(u) for u in sorted(bank._blacklist)],
        "redispatches": bank.stats.faults.redispatches}

    # -- 3. chip tier: same model, one K6 launch an attempt -----------------
    chip = SimdramChip(n_banks=2, n_subarrays=2,
                       fault=FaultModel(sigma=0.15, spare_lanes=1, seed=5),
                       device=device)
    ref = SimdramChip(n_banks=2, n_subarrays=2,
                      device=device).dispatch(queue())
    got = chip.dispatch(queue())
    exact = all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(ref, got))
    print(f"chip tier bit-exact: {exact}, stats: "
          f"{chip.stats.faults.as_dict()}\n")
    out["results"]["chip_clean"] = _values(ref)
    out["drawn"]["chip"] = {"exact": exact, "results": _values(got),
                            "faults": chip.stats.faults.as_dict()}

    # -- 4. graceful exhaustion ---------------------------------------------
    hopeless = Bank(n_subarrays=2,
                    fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                     spare_lanes=1, seed=1,
                                     max_redispatches=1),
                    device=device)
    try:
        hopeless.dispatch(queue())
    except FaultExhaustedError as e:
        print(f"every subarray dead → FaultExhaustedError: {e}")
        print("(the serving path catches this and falls back to the host "
              "oracle — see PumServeOffload.host_fallbacks)\n")
        out["modeled"]["exhausted"] = str(e)

    # -- 5. disabled model is free ------------------------------------------
    off = Bank(n_subarrays=4, fault=FaultModel(enabled=False), device=device)
    got = off.dispatch(queue())
    plain = Bank(n_subarrays=4, device=device)
    plain.dispatch(queue())
    print(f"disabled model: fault hooks installed = {off.fault is not None}, "
          f"overhead = {off.stats.faults.overhead_s}, "
          f"latency identical to plain bank = "
          f"{off.stats.latency_s == plain.stats.latency_s}")
    out["results"]["disabled"] = _values(got)
    out["modeled"]["disabled"] = {
        "hooks": off.fault is not None,
        "overhead_s": off.stats.faults.overhead_s,
        "stats": {k: v for k, v in off.stats.as_dict().items()
                  if k not in MEASURED}}

    after = kernel_counts()["launches"]
    out["launches"] = {k: after[k] - launches0[k] for k in after}
    return out


if __name__ == "__main__":
    main()
