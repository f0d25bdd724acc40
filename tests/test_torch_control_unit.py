"""The port's control unit mirrored from the reference's tests, on the CPU.

Mirrors ``tests/test_control_unit.py`` (the replay ≡ the subarray
oracle, programs are data, the device backends agree — with the port's
``cuda`` backend beside the reference's three) and the non-LM cases of
``tests/test_system.py`` (a user-defined operation through the three
steps, the offload cost model).  The replay is the plain version of K5
on the CPU; its states are held ``==`` the reference's ``Subarray``
running the reference's program.  The last case holds
``benchmarks/fault_sweep.py --smoke``'s gate on the port: all 16 ops ×
{mig, aig} at its 64 lanes through a faulty 2-bank × 4-subarray chip at
sigma 0.15 with one spare lane (stuck lanes 0.002, seed 0, 50,000
reliability trials) are exact after vote and retry: ``==`` the clean
chip, which equals the reference's oracles.
"""

import numpy as np
import pytest

from test_torch_examples_core import one_torch_thread  # noqa: F401
from repro.core import subarray as ref_subarray
from repro.core.isa import compile_op as ref_compile_op
from repro_torch.core.control_unit import (encode_uprogram, kernel_counts,
                                           make_interpreter)
from repro_torch.core import subarray
from repro_torch.core.isa import SimdramDevice, compile_op

CPU = "cpu"


def _initial(up, ops_vals, cols, mod):
    """A subarray of package ``mod`` with the operands loaded, and the
    same state as (rows, words) uint32."""
    sa = mod.Subarray(up.n_rows_total, cols)
    state = np.zeros((up.n_rows_total, cols // 32), np.uint32)
    state[7] = 0xFFFFFFFF
    for op_idx, rows in enumerate(up.in_rows):
        planes = mod.pack_bits(ops_vals[op_idx], len(rows), cols)
        for j, r in enumerate(rows):
            sa.rows[r] = planes[j]
            state[r] = planes[j]
    return sa, state


@pytest.mark.parametrize("name", ["addition", "greater", "if_else", "relu",
                                  "bitcount", "xor_red"])
def test_interpreter_equals_subarray(name):
    n, cols = 8, 64
    spec, up = compile_op(name, n)
    rng = np.random.default_rng(11)
    ops_vals = [rng.integers(0, 1 << w, size=cols).astype(np.uint64)
                for w in spec.operand_bits]
    sa, state = _initial(up, ops_vals, cols, subarray)
    sa.execute(up.commands)
    out = make_interpreter(CPU)(state, encode_uprogram(up))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), sa.rows)
    _, ref_up = ref_compile_op(name, n)
    ref_sa, _ = _initial(ref_up, ops_vals, cols, ref_subarray)
    ref_sa.execute(ref_up.commands)
    np.testing.assert_array_equal(sa.rows, ref_sa.rows)


def test_same_length_programs_share_one_executable():
    """Programs are data: a mutated table of the same shape replays with
    no new kernel build (and, on the CPU, no launch)."""
    run = make_interpreter(CPU)
    _, up1 = compile_op("addition", 8)
    t1 = encode_uprogram(up1)
    state = np.zeros((up1.n_rows_total, 2), np.uint32)
    run(state, t1)
    before = kernel_counts()
    t2 = np.array(t1)
    t2[0], t2[1] = t1[1].copy(), t1[0].copy()
    run(state, t2)
    assert kernel_counts() == before


@pytest.mark.parametrize("backend", ["subarray", "interp", "bitplane",
                                     "cuda"])
def test_device_backends_agree(backend):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=70).astype(np.int64)
    y = rng.integers(0, 256, size=70).astype(np.int64)
    dev = SimdramDevice(backend=backend, device=CPU)
    got = np.asarray(dev.bbop("addition", x, y, n_bits=8)).astype(np.int64)
    np.testing.assert_array_equal(got, (x + y) % 256)
    got = np.asarray(dev.bbop("greater", x, y, n_bits=8)).astype(np.int64)
    np.testing.assert_array_equal(got, (x > y).astype(np.int64))


def _mac(mods):
    """The fused MAC a*b+c (6-bit operands, 12-bit accumulator) through
    Steps 1-2 of package ``mods`` (arith, logic, synthesis, allocation)."""
    arith, logic, synthesis, allocation = mods
    n = 6
    c = logic.Circuit()
    g = arith.Gates(c, "mig")
    x = logic.input_vec(c, "x", n)
    y = logic.input_vec(c, "y", n)
    z = logic.input_vec(c, "z", 2 * n)
    s, _ = g.add(g.mul(x, y), z)
    logic.mark_output_vec(c, s, "mac")
    opt, _ = synthesis.synthesize(c)
    assert opt.is_mig()
    name2id = {opt.names[i]: i for i in range(len(opt.ops))
               if opt.ops[i] == "in"}
    ids = [[name2id[c.names[b]] for b in vec.bits] for vec in (x, y, z)]
    return allocation.compile_circuit(opt, ids, op_name="mac", n_bits=n)


def test_user_defined_operation_end_to_end():
    """A NEW operation (a*b+c) through the same three steps the built-ins
    use: the reference's commands, and exact on the DRAM oracle."""
    from repro.core import allocation as r_alloc
    from repro.core import arith as r_arith
    from repro.core import logic as r_logic
    from repro.core import synthesis as r_synth
    from repro_torch.core import allocation, arith, logic, synthesis
    from repro_torch.core.subarray import run_op
    up = _mac((arith, logic, synthesis, allocation))
    ref_up = _mac((r_arith, r_logic, r_synth, r_alloc))
    assert [repr(c) for c in up.commands] == [repr(c)
                                              for c in ref_up.commands]
    assert (up.n_aap, up.n_ap) == (ref_up.n_aap, ref_up.n_ap)
    rng = np.random.default_rng(0)
    xv = rng.integers(0, 1 << 6, 64).astype(np.uint64)
    yv = rng.integers(0, 1 << 6, 64).astype(np.uint64)
    zv = rng.integers(0, 1 << 12, 64).astype(np.uint64)
    (got,) = run_op(up, [12], [xv, yv, zv])
    np.testing.assert_array_equal(got & np.uint64(0xFFF),
                                  (xv * yv + zv) & np.uint64(0xFFF))


def test_offload_cost_model_integration():
    from repro.core.costmodel import decide as ref_decide
    from repro_torch.core.costmodel import decide
    plan = decide("relu", 8, 1 << 22, operands_vertical=1,
                  result_stays_vertical=True)
    assert plan.offload
    assert plan.speedup > 1
    ref = ref_decide("relu", 8, 1 << 22, operands_vertical=1,
                     result_stays_vertical=True)
    for k in plan.__dataclass_fields__:
        assert getattr(plan, k) == getattr(ref, k), k


@pytest.mark.parametrize("style", ["mig", "aig"])
def test_fault_sweep_smoke_gate(style):
    """``benchmarks/fault_sweep.py --smoke``'s gate on the port's chip."""
    from benchmarks.chip_scaling import _gate_queue
    from repro.core.ops_library import get_op as ref_get_op
    from repro_torch.core.bank import BbopInstr, flatten_result
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.fault import FaultModel
    queue = [BbopInstr(i.op, i.operands, i.n_bits)
             for i in _gate_queue(style, 64)]
    assert len(queue) == 16
    model = FaultModel(sigma=0.15, p_trials=50_000, spare_lanes=1,
                       stuck_lane_rate=0.002, seed=0)
    clean = SimdramChip(n_banks=2, n_subarrays=4, style=style,
                        device=CPU).dispatch(queue)
    chip = SimdramChip(n_banks=2, n_subarrays=4, style=style, fault=model,
                       device=CPU)
    faulty = chip.dispatch(queue)
    for i, (ins, a, b) in enumerate(zip(queue, faulty, clean)):
        for x, y in zip(flatten_result(a), flatten_result(b)):
            np.testing.assert_array_equal(x, y, err_msg=f"instr {i}")
        spec = ref_get_op(ins.op, 8)
        want = spec.oracle(*ins.operands)
        for gi, (y, e) in enumerate(zip(flatten_result(b), want)):
            mask = (1 << spec.out_bits[gi]) - 1
            np.testing.assert_array_equal(
                np.asarray(y).astype(np.int64) & mask,
                e.astype(np.int64) & mask, err_msg=f"instr {i}")
    fs = chip.stats.faults
    assert fs.injected > 0 and fs.host_fallbacks == 0
    assert fs.corrected <= fs.detected <= fs.injected
