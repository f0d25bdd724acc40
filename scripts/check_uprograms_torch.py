"""Quick full validation of the PyTorch port's compiler: all 16 ops, SIMDRAM (MIG) + Ambit (AIG) uPrograms on the DRAM simulator.

The port's counterpart of ``scripts/check_uprograms.py``: the same ops,
widths, lanes and seed through ``repro_torch``'s ``synthesize``,
``to_mig``, ``compile_circuit`` and ``subarray.run_op``, and the same
table.  Pure numpy and Python: it needs no card.

    PYTHONPATH=src python scripts/check_uprograms_torch.py [N_BITS]
"""
import numpy as np
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.synthesis import synthesize, to_mig
from repro_torch.core.allocation import compile_circuit
from repro_torch.core.subarray import run_op

def remap(circ_src, circ_dst, ids):
    name2id = {circ_dst.names[i]: i for i in range(len(circ_dst.ops)) if circ_dst.ops[i] == "in"}
    return [[name2id[circ_src.names[nid]] for nid in op] for op in ids]

def main(n=8, lanes=192, seed=1):
    rng = np.random.default_rng(seed)
    rows = []
    for name in ALL_OPS:
        spec = get_op(name, n)
        mig_c, ids = spec.build("mig")
        mig, _ = synthesize(mig_c)
        up = compile_circuit(mig, remap(mig_c, mig, ids), op_name=name, n_bits=n)
        aig_c, ids_a = spec.build("aig")
        amb = to_mig(aig_c)
        up_a = compile_circuit(amb, remap(aig_c, amb, ids_a), op_name=name, n_bits=n)
        ops_vals = [rng.integers(0, 1 << w, size=lanes).astype(np.uint64) for w in spec.operand_bits]
        exp = spec.oracle(*ops_vals)
        for tag, u in (("simdram", up), ("ambit", up_a)):
            got = run_op(u, spec.out_bits, ops_vals)
            for gi, (g, e) in enumerate(zip(got, exp)):
                mask = np.uint64((1 << spec.out_bits[gi]) - 1)
                assert np.array_equal(g & mask, e & mask), (name, tag, gi, g[:8], (e & mask)[:8])
        rows.append((name, up.n_aap, up.n_ap, up.n_activations, up_a.n_aap, up_a.n_ap, up_a.n_activations, up.n_scratch))
    print(f"{'op':14s} {'SD_AAP':>6s} {'SD_AP':>5s} {'SD_ACT':>6s} {'AM_AAP':>6s} {'AM_AP':>5s} {'AM_ACT':>6s} {'spill':>5s} {'AM/SD':>5s}")
    tot_s = tot_a = 0
    for r in rows:
        tot_s += r[3]; tot_a += r[6]
        print(f"{r[0]:14s} {r[1]:6d} {r[2]:5d} {r[3]:6d} {r[4]:6d} {r[5]:5d} {r[6]:6d} {r[7]:5d} {r[6]/r[3]:5.2f}")
    print(f"TOTAL ACT: simdram={tot_s} ambit={tot_a} ratio={tot_a/tot_s:.2f}")
    print(f"ALL UPROGRAMS CORRECT ({n}-bit, {lanes} lanes)")

if __name__ == "__main__":
    import sys
    main(n=int(sys.argv[1]) if len(sys.argv) > 1 else 8)
