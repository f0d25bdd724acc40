"""Share of wrong lanes in a fault-injected bank dispatch, per seed.

    PYTHONPATH=src python experiments/fault_share.py --impl reference \
        --seeds 0 1 2 --json OUT.json          # the JAX package, on the CPU
    PYTHONPATH=src python experiments/fault_share.py --impl port \
        --seeds 0 1 2 --json OUT.json          # repro_torch, on a CUDA card

Runs ``SimdramDevice(backend="bank", fault=model)`` over the mix queue of
``benchmarks/bank_scaling.py`` (32 instructions, ``addition``,
``multiplication``, ``greater`` and ``and_red`` at 8 and 16 bits, data
seed 0) in the two fault configurations that ``chip_smoke.py`` phase 6
drives, once per fault seed:

  sigma  ``FaultModel(sigma=0.15, spare_lanes=1, max_retries=10)`` at
         32,768 lanes per instruction (two replicas fill each of the 16
         subarrays' 65,536 columns);
  stuck  ``FaultModel(p_flip=1e-3, stuck_lane_rate=0.02, spare_lanes=2)``
         at 16,384 lanes per instruction.

For each run it records whether the dispatch returned or raised
``FaultExhaustedError`` (with the error's context), the lanes whose
result differs from the op's oracle, and the ``FaultStats``.  The two
implementations draw different random bits (``jax.random`` against
Philox4x32-10), so they are compared by these shares, not lane by lane.
Only the chosen implementation is imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

MIX_OPS = ("addition", "multiplication", "greater", "and_red")
CONFIGS = {
    "sigma": (32768, dict(sigma=0.15, spare_lanes=1, max_retries=10)),
    "stuck": (16384, dict(p_flip=1e-3, stuck_lane_rate=0.02,
                          spare_lanes=2)),
}


def mix_queue(bank_mod, get_op, lanes, n_instrs=32, widths=(8, 16), seed=0):
    """benchmarks/bank_scaling.py:_mix_queue on either package."""
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(n_instrs):
        op = MIX_OPS[i % len(MIX_OPS)]
        w = widths[(i // len(MIX_OPS)) % len(widths)]
        ops = tuple(rng.integers(0, 1 << b, lanes).astype(np.uint64)
                    for b in get_op(op, w).operand_bits)
        queue.append(bank_mod.BbopInstr(op, ops, w))
    return queue


def modules(impl: str):
    if impl == "reference":
        from repro.core import bank, fault, isa, ops_library
        return bank, fault, isa, ops_library, {}
    from repro_torch.core import bank, fault, isa, ops_library
    return bank, fault, isa, ops_library, {"device": "cuda"}


def wrong_lanes(bank_mod, get_op, queue, results) -> dict:
    """{"i op/width": [lanes, first XORs of got and oracle]} over the
    instructions with a wrong lane (output-width masked)."""
    wrong = {}
    for i, ins in enumerate(queue):
        spec = get_op(ins.op, ins.n_bits)
        n_bad, xors = 0, []
        for g, e, w in zip(bank_mod.flatten_result(results[i]),
                           spec.oracle(*ins.operands), spec.out_bits):
            g = np.asarray(g).astype(np.int64) & ((1 << w) - 1)
            e = np.asarray(e).astype(np.int64) & ((1 << w) - 1)
            bad = g != e
            n_bad += int(bad.sum())
            xors += (g[bad] ^ e[bad])[:4].tolist()
        if n_bad:
            wrong[f"{i} {ins.op}/{ins.n_bits}"] = [n_bad, xors]
    return wrong


def run(impl: str, config: str, seed: int) -> dict:
    bank_mod, fault_mod, isa, ops_library, kw = modules(impl)
    lanes, params = CONFIGS[config]
    queue = mix_queue(bank_mod, ops_library.get_op, lanes)
    model = fault_mod.FaultModel(seed=seed, **params)
    dev = isa.SimdramDevice(backend="bank", fault=model, **kw)
    t0 = time.perf_counter()
    row = {"impl": impl, "config": config, "seed": seed, "lanes": lanes,
           "instructions": len(queue)}
    try:
        res = dev.dispatch(queue)
        wrong = wrong_lanes(bank_mod, ops_library.get_op, queue, res)
        n_wrong = sum(n for n, _ in wrong.values())
        row.update(outcome="returned", wrong_lanes=n_wrong,
                   wrong_share=n_wrong / (lanes * len(queue)), wrong=wrong)
    except fault_mod.FaultExhaustedError as e:
        row.update(outcome="exhausted", context=e.context())
    row["wall_s"] = time.perf_counter() - t0
    row["stats"] = dev.bank().stats.faults.as_dict()
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", choices=("reference", "port"), required=True)
    p.add_argument("--configs", nargs="+", choices=tuple(CONFIGS),
                   default=list(CONFIGS))
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--json", help="write every run's row here")
    args = p.parse_args()
    rows = []
    for config in args.configs:
        for seed in args.seeds:
            row = run(args.impl, config, seed)
            rows.append(row)
            brief = {k: row[k] for k in ("impl", "config", "seed", "outcome",
                                         "wall_s")}
            brief.update({k: row[k] for k in ("wrong_lanes", "wrong_share")
                          if k in row})
            brief["stats"] = {k: row["stats"][k] for k in (
                "injected", "detected", "corrected", "retries",
                "redispatches", "remapped")}
            if row["outcome"] == "exhausted":
                brief["cause"] = row["context"].get("cause")
            print(json.dumps(brief), flush=True)
            if args.json:
                Path(args.json).parent.mkdir(parents=True, exist_ok=True)
                Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
