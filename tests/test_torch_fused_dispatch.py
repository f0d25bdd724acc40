"""The port's fused dataflow dispatcher vs its grouped baseline and the
JAX package, on the CPU.

Mirrors ``tests/test_fused_dispatch.py`` case by case: the port's fused
``Bank`` (``device="cpu"``) against its grouped one, bit for bit, and
both against the reference's fused bank (results ``==``, modeled
``BankStats`` ``==``).  It also guards the two seams the chip tier
stacks through: ``Bank._pack_wave`` with wider dims and
``with_tables=False``, and ``Bank._harvest_out``.
"""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import bank as ref_bank
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.bank import (Bank, BbopInstr, Ref, VerticalOperand,
                                   flatten_result)
from repro_torch.core.costmodel import forwarding_saving_s
from repro_torch.core.isa import compile_op
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.timing import fused_replay_latency_s, uprogram_latency_s

LANES = 64
MEASURED = ("wall_s", "pack_wall_s")


def _rand_instr(mod, rng, op, n_bits, lanes=LANES, **kw):
    spec = get_op(op, n_bits)
    ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                for w in spec.operand_bits)
    return mod.BbopInstr(op, ops, n_bits, **kw)


def _values(result):
    outs = result if isinstance(result, tuple) else (result,)
    return [o.to_values() if hasattr(o, "to_values") else np.asarray(o)
            for o in outs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        fa, fb = _values(a), _values(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y, err_msg=f"instr {i}")


def _modeled(stats):
    d = stats.as_dict()
    return {k: v for k, v in d.items() if k not in MEASURED}


def _bank(**kw):
    return Bank(device="cpu", **kw)


def _both(build, n_subarrays=4, style="mig", **bank_kw):
    """Port fused == port grouped == reference fused; the fused modeled
    stats == the reference's."""
    fused = _bank(n_subarrays=n_subarrays, style=style, fuse=True, **bank_kw)
    grouped = _bank(n_subarrays=n_subarrays, style=style, fuse=False)
    rf = fused.dispatch(build(pt_bank))
    rg = grouped.dispatch(build(pt_bank))
    _assert_same(rf, rg)
    ref = ref_bank.Bank(n_subarrays=n_subarrays, style=style, fuse=True,
                        **bank_kw)
    _assert_same(rf, ref.dispatch(build(ref_bank)))
    assert _modeled(fused.stats) == _modeled(ref.stats)
    return fused, grouped, rf


# --- bit-exactness --------------------------------------------------------

@pytest.mark.parametrize("style", ["mig", "aig"])
def test_fused_matches_grouped_all_ops(style):
    ops = [op for op in ALL_OPS
           if style == "mig" or op not in ("division", "multiplication")]

    def build(mod):
        rng = np.random.default_rng({"mig": 0, "aig": 1}[style])
        return [_rand_instr(mod, rng, op, 8) for op in ops]

    fused, grouped, _ = _both(build, style=style)
    assert fused.stats.bbops == grouped.stats.bbops == len(ops)
    assert fused.stats.batches < grouped.stats.batches


@given(st.integers(2, 6), st.integers(1, 4), st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_fused_property_random_queues(n_bits, n_subarrays, seed):
    def build(mod):
        rng = np.random.default_rng(seed)
        ops = ("addition", "subtraction", "min", "max", "greater", "relu")
        queue = []
        for _ in range(int(rng.integers(1, 10))):
            op = ops[int(rng.integers(0, len(ops)))]
            lanes = int(rng.integers(1, 70))
            signed = bool(rng.integers(0, 2)) and op != "greater"
            queue.append(_rand_instr(mod, rng, op, n_bits, lanes=lanes,
                                     signed_out=signed))
        return queue

    _both(build, n_subarrays=n_subarrays)


# --- replay-count and latency acceptance ----------------------------------

def _hetero_mix(mod, seed=0):
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(16):
        op = ("addition", "multiplication", "greater", "and_red")[i % 4]
        n_bits = (8, 16)[(i // 4) % 2]
        queue.append(_rand_instr(mod, rng, op, n_bits))
    return queue


def test_fused_halves_replays_on_hetero_mix():
    fused, grouped, _ = _both(_hetero_mix)
    assert fused.stats.batches * 2 <= grouped.stats.batches
    assert fused.stats.latency_s < grouped.stats.latency_s
    assert fused.stats.fused_batches > 0
    assert fused.stats.aap == grouped.stats.aap
    assert fused.stats.ap == grouped.stats.ap
    assert fused.stats.elements == grouped.stats.elements


def test_fused_wave_charges_longest_constituent():
    rng = np.random.default_rng(1)
    queue = [_rand_instr(pt_bank, rng, "multiplication", 8),
             _rand_instr(pt_bank, rng, "greater", 8)]
    bank = _bank(n_subarrays=4)
    bank.dispatch(queue)
    _, up_mul = compile_op("multiplication", 8)
    _, up_gt = compile_op("greater", 8)
    assert bank.stats.batches == 1
    assert bank.stats.latency_s == pytest.approx(uprogram_latency_s(up_mul))
    assert bank.stats.latency_s == pytest.approx(
        fused_replay_latency_s([up_mul, up_gt]))
    assert bank.stats.aap == up_mul.n_aap + up_gt.n_aap


def test_fuse_ratio_falls_back_to_separate_replays():
    def build(mod):
        rng = np.random.default_rng(2)
        return [_rand_instr(mod, rng, "multiplication", 16),
                _rand_instr(mod, rng, "greater", 8)]

    fused, _, _ = _both(build, fuse_ratio=2)
    assert fused.stats.batches == 2
    assert fused.stats.fused_batches == 0
    fused2 = _bank(n_subarrays=4, fuse_ratio=128)
    fused2.dispatch(build(pt_bank))
    assert fused2.stats.batches == 1
    with pytest.raises(ValueError):
        _bank(fuse_ratio=0)


def test_ffd_packing_never_worse_than_greedy():
    ffd = _bank(n_subarrays=4, packing="ffd")
    greedy = _bank(n_subarrays=4, packing="greedy")
    rf = ffd.dispatch(_hetero_mix(pt_bank, 20))
    rp = greedy.dispatch(_hetero_mix(pt_bank, 20))
    _assert_same(rf, rp)
    assert ffd.stats.latency_s <= greedy.stats.latency_s
    assert ffd.stats.batches <= greedy.stats.batches
    ref = ref_bank.Bank(n_subarrays=4, packing="ffd")
    _assert_same(rf, ref.dispatch(_hetero_mix(ref_bank, 20)))
    assert _modeled(ffd.stats) == _modeled(ref.stats)
    with pytest.raises(ValueError, match="packing"):
        _bank(packing="worst-fit")


def test_ffd_revisits_open_waves():
    bank = _bank(n_subarrays=2, fuse_ratio=4)
    sizes = {0: (2048, 16), 1: (512, 128), 2: (512, 32), 3: (512, 32)}
    idxs = [0, 1, 2, 3]
    ffd = bank._ffd_waves(idxs, lambda i: sizes[i])
    greedy = bank._greedy_waves(idxs, lambda i: sizes[i])
    assert greedy == [[0], [1, 2], [3]]
    assert ffd == [[0, 2], [1, 3]]
    ref = ref_bank.Bank(n_subarrays=2, fuse_ratio=4)
    assert ffd == ref._ffd_waves(idxs, lambda i: sizes[i])
    assert greedy == ref._greedy_waves(idxs, lambda i: sizes[i])


def test_fused_lane_load_balancing():
    def build(mod):
        rng = np.random.default_rng(22)
        return [_rand_instr(mod, rng, "addition", 8, lanes=n)
                for n in (96, 32, 32, 32, 96, 32, 32, 32)]

    bank = _bank(n_subarrays=2)
    bank.dispatch(build(pt_bank))
    assert int(bank._lane_load.sum()) == 384
    assert abs(int(bank._lane_load[0]) - int(bank._lane_load[1])) <= 64
    ref = ref_bank.Bank(n_subarrays=2)
    ref.dispatch(build(ref_bank))
    np.testing.assert_array_equal(bank._lane_load, ref._lane_load)


def test_hetero_mixes_share_cached_tables():
    """Tables are data: mixes seen before replay from the table cache —
    no table is encoded again and no kernel is built (the reference
    counts zero new compilations)."""
    rng = np.random.default_rng(3)
    mixes = [("addition", "subtraction"), ("min", "max"),
             ("subtraction", "addition")]
    bank = _bank(n_subarrays=2)
    for mix in mixes:
        bank.dispatch([_rand_instr(pt_bank, rng, op, 8) for op in mix])
    bank.reset_stats()
    k0, misses = cu.kernel_counts(), cu.TABLE_CACHE.stats()["misses"]
    for mix in mixes:
        bank.dispatch([_rand_instr(pt_bank, rng, op, 8) for op in mix])
    assert cu.TABLE_CACHE.stats()["misses"] == misses
    assert cu.kernel_counts()["builds"] == k0["builds"]


# --- vertical operand forwarding ------------------------------------------

def _chain3(mod):
    rng = np.random.default_rng(4)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    z = rng.integers(0, 1 << 16, LANES).astype(np.uint64)
    return [mod.BbopInstr("multiplication", (x, y), 8),
            mod.BbopInstr("addition", (mod.Ref(0), z), 16),
            mod.BbopInstr("relu", (mod.Ref(1),), 16)], (x, y, z)


def test_chain_forwards_vertically_and_prices_skips():
    fused, grouped, rf = _both(lambda mod: _chain3(mod)[0])
    x, y, z = _chain3(pt_bank)[1]
    want = (x * y + z) & 0xFFFF
    np.testing.assert_array_equal(np.asarray(rf[2]) & 0xFFFF,
                                  np.where(want >= 1 << 15, 0, want))
    assert fused.stats.transpositions_skipped == 2
    assert fused.stats.transpose_s_saved == pytest.approx(
        forwarding_saving_s(LANES, 16) * 2)
    assert grouped.stats.transpositions_skipped == 0


def test_chain_width_mismatch_narrow_and_wide():
    def build(mod):
        rng = np.random.default_rng(5)
        x, y = (rng.integers(0, 256, LANES).astype(np.uint64)
                for _ in range(2))
        z8 = rng.integers(0, 256, LANES).astype(np.uint64)
        z16 = rng.integers(0, 1 << 16, LANES).astype(np.uint64)
        return [
            mod.BbopInstr("multiplication", (x, y), 8),
            mod.BbopInstr("addition", (mod.Ref(0), z8), 8),
            mod.BbopInstr("greater", (x, y), 8),
            mod.BbopInstr("if_else", (mod.Ref(2), x, y), 8),
            mod.BbopInstr("subtraction", (x, y), 8, signed_out=True),
            mod.BbopInstr("addition", (mod.Ref(4), z16), 16),
        ]

    _, _, rf = _both(build)
    q = build(pt_bank)
    x, y = q[0].operands
    z8, z16 = q[1].operands[1], q[5].operands[1]
    np.testing.assert_array_equal(np.asarray(rf[1]) & 0xFF,
                                  (x * y + z8) & 0xFF)
    np.testing.assert_array_equal(np.asarray(rf[3]) & 0xFF,
                                  np.where(x > y, x, y))
    diff = x.astype(np.int64) - y.astype(np.int64)
    signed8 = ((diff & 0xFF) ^ 0x80) - 0x80
    np.testing.assert_array_equal(np.asarray(rf[5]) & 0xFFFF,
                                  (signed8 + z16.astype(np.int64)) & 0xFFFF)


def test_multi_output_ref_selects_component():
    def build(mod):
        rng = np.random.default_rng(6)
        x = rng.integers(0, 256, LANES).astype(np.uint64)
        y = rng.integers(1, 256, LANES).astype(np.uint64)
        return [mod.BbopInstr("division", (x, y), 8),
                mod.BbopInstr("addition", (mod.Ref(0, out=1), y), 8)]

    _, _, rf = _both(build)
    x, y = build(pt_bank)[0].operands
    np.testing.assert_array_equal(np.asarray(rf[1]) & 0xFF,
                                  (x % y + y) & 0xFF)


def test_vertical_operand_in_and_out():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, 100).astype(np.uint64)
    y = rng.integers(0, 256, 100).astype(np.uint64)

    def build(mod):
        kw = {"device": "cpu"} if mod is pt_bank else {}
        vo = mod.VerticalOperand.from_values(x, 8, **kw)
        return [mod.BbopInstr("addition", (vo, y), 8, keep_vertical=True)]

    vo = VerticalOperand.from_values(x, 8, device="cpu")
    np.testing.assert_array_equal(vo.to_values() & 0xFF, x)
    fused, _, rf = _both(build, n_subarrays=2)
    assert isinstance(rf[0], VerticalOperand)
    np.testing.assert_array_equal(rf[0].to_values() & 0xFF, (x + y) & 0xFF)
    assert fused.stats.transpositions_skipped == 2
    assert fused.stats.transpose_s_saved > 0
    assert {"fused_batches", "transpositions_skipped",
            "transpose_s_saved"} <= set(fused.stats.as_dict())


def test_signed_keep_vertical_roundtrip():
    def build(mod):
        rng = np.random.default_rng(8)
        x, y = (rng.integers(0, 256, LANES).astype(np.uint64)
                for _ in range(2))
        return [mod.BbopInstr("subtraction", (x, y), 8, signed_out=True,
                              keep_vertical=True)]

    _, _, rf = _both(build)
    x, y = build(pt_bank)[0].operands
    want = (x.astype(np.int64) - y.astype(np.int64)) & 0xFF
    want = np.where(want >= 128, want - 256, want)
    np.testing.assert_array_equal(rf[0].to_values(signed=True), want)


# --- dispatcher edge cases ------------------------------------------------

def test_empty_queue():
    bank = _bank(n_subarrays=4)
    assert bank.dispatch([]) == []
    assert bank.stats.batches == 0 and bank.stats.bbops == 0


def test_zero_lane_instruction_in_mixed_queue():
    def build(mod):
        rng = np.random.default_rng(9)
        e = np.zeros(0, np.uint64)
        return [
            _rand_instr(mod, rng, "addition", 8),
            mod.BbopInstr("addition", (e, e), 8),
            mod.BbopInstr("relu", (mod.Ref(1),), 8),
            mod.BbopInstr("division", (e, e), 8),
            mod.BbopInstr("abs", (e,), 8, keep_vertical=True),
            _rand_instr(mod, rng, "greater", 8),
        ]

    fused, _, rf = _both(build)
    assert np.asarray(rf[1]).shape == (0,)
    assert np.asarray(rf[2]).shape == (0,)
    assert all(np.asarray(o).shape == (0,) for o in rf[3])
    assert isinstance(rf[4], VerticalOperand) and rf[4].lanes == 0
    assert fused.stats.bbops == 6
    assert fused.stats.subarray_programs.sum() == 2


def round_robin_case(n_instrs: int, seed: int, lanes: int):
    """A queue of ``n_instrs`` 8-bit addition/subtraction/min (cycled)
    over a 4-subarray bank: oracle-exact, the reference's results and
    modeled stats (``_both``), every instruction placed once and no
    subarray more than two programs ahead.  Also run at
    ``tests/test_bank_engine.py``'s queue by
    ``tests/test_torch_bank_engine.py``.  Returns the fused bank."""
    def build(mod):
        rng = np.random.default_rng(seed)
        return [_rand_instr(mod, rng, ("addition", "subtraction", "min")[i % 3],
                            8, lanes=lanes) for i in range(n_instrs)]

    fused, _, rf = _both(build, n_subarrays=4)
    for ins, got in zip(build(pt_bank), rf):
        want = get_op(ins.op, 8).oracle(
            *[np.asarray(o).astype(np.uint64) for o in ins.operands])[0]
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64) & 0xFF,
                                      want.astype(np.int64) & 0xFF)
    progs = fused.stats.subarray_programs
    assert progs.sum() == n_instrs
    assert progs.max() - progs.min() <= 2
    return fused


def test_round_robin_wraparound_large_queue():
    round_robin_case(23, seed=10, lanes=32)


def test_ref_validation():
    x = np.ones(4, np.uint64)
    with pytest.raises(ValueError, match="must precede"):
        _bank().dispatch([BbopInstr("addition", (Ref(0), x), 8)])
    with pytest.raises(ValueError, match="out of range"):
        _bank().dispatch([BbopInstr("addition", (x, x), 8),
                          BbopInstr("addition", (Ref(0, out=1), x), 8)])
    with pytest.raises(ValueError):
        BbopInstr("addition", (Ref(0), x), 8).elements


def test_lane_mismatched_vertical_operands_rejected():
    small = np.ones(8, np.uint64)
    big = np.ones(64, np.uint64)
    queue = [BbopInstr("equal", (small, small), 8),
             BbopInstr("addition", (big, Ref(0)), 8)]
    for fuse in (True, False):
        with pytest.raises(ValueError, match="8 lanes"):
            _bank(fuse=fuse).dispatch(queue)
    vo = VerticalOperand.from_values(small, 8, device="cpu")
    with pytest.raises(ValueError, match="8 lanes"):
        _bank().dispatch([BbopInstr("addition", (big, vo), 8)])


def test_vertical_operand_empty_roundtrip():
    vo = VerticalOperand.from_values(np.zeros(0, np.uint64), 8, device="cpu")
    assert vo.lanes == 0 and vo.planes.shape == (8, 0)
    assert vo.to_values().shape == (0,)


def test_device_dispatch_routes_through_fused_bank():
    from repro.core.isa import SimdramDevice as RefDevice
    from repro.core.timing import DramConfig as RefConfig
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DramConfig

    dev = SimdramDevice(cfg=DramConfig(n_banks=4), backend="bank",
                        device="cpu")
    ref = RefDevice(cfg=RefConfig(n_banks=4), backend="bank")
    rng = np.random.default_rng(12)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    out = dev.dispatch([BbopInstr("addition", (x, y), 8),
                        BbopInstr("relu", (Ref(0),), 8)])
    ref.dispatch([ref_bank.BbopInstr("addition", (x, y), 8),
                  ref_bank.BbopInstr("relu", (ref_bank.Ref(0),), 8)])
    want = (x + y) & 0xFF
    np.testing.assert_array_equal(np.asarray(out[1]) & 0xFF,
                                  np.where(want >= 128, 0, want))
    assert dev.totals()["calls"] == 2
    assert dev.bank().stats.batches == 2
    assert dev.bank().stats.transpositions_skipped == 1
    assert all(c.elements == LANES for c in dev.calls)
    assert [vars(c) for c in dev.calls] == [vars(c) for c in ref.calls]


def test_grouped_engines_support_refs_too():
    rng = np.random.default_rng(11)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    queue = [BbopInstr("addition", (x, y), 8),
             BbopInstr("subtraction", (Ref(0), y), 8)]
    bank = _bank(n_subarrays=2, engine="bitplane")
    out = bank.dispatch(queue)
    np.testing.assert_array_equal(np.asarray(out[1]) & 0xFF, x & 0xFF)
    assert bank.stats.transpositions_skipped == 0


# --- the seams the chip tier stacks through ----------------------------------

def test_pack_wave_at_wider_dims_without_tables():
    """``_pack_wave`` at a round's wider dims pads inertly and, with
    ``with_tables=False``, returns the wave's key in place of tables —
    as the reference's does."""
    queue_pt, queue_ref = _hetero_mix(pt_bank), _hetero_mix(ref_bank)
    lanes, stage, _ = pt_bank.plan_queue(queue_pt)
    port, ref = _bank(n_subarrays=4), ref_bank.Bank(n_subarrays=4)
    wave = port._build_waves(queue_pt, list(range(16)), stage, lanes)[1]
    own = port._wave_dims(queue_pt, wave, lanes)
    dims = dict(n_rows=2 * own[0], n_cmds=2 * own[1], cols=2 * own[2])
    st, key, entries = port._pack_wave(queue_pt, wave, lanes, {},
                                       with_tables=False, **dims)
    rst, rkey, rentries = ref._pack_wave(queue_ref, wave, lanes, {},
                                         with_tables=False, **dims)
    np.testing.assert_array_equal(st, rst)
    assert st.shape == (4, dims["n_rows"], dims["cols"] // 32)
    assert key == rkey and key[1] == dims["n_cmds"]
    assert [(e.qi, e.sid, e.lanes) for e in entries] == \
        [(e.qi, e.sid, e.lanes) for e in rentries]
    assert _modeled(port.stats) == _modeled(ref.stats)
    # with tables: the cached CommandTables of the same key
    port2 = _bank(n_subarrays=4)
    st2, ct, _ = port2._pack_wave(queue_pt, wave, lanes, {})
    assert isinstance(ct, cu.CommandTables)
    assert ct.tables.shape == (4, own[1], 13)


def test_harvest_out_reads_an_executed_stack():
    """``_harvest_out`` on a host array gives what the wave's dispatch
    gives, forwarded planes included."""
    queue = _chain3(pt_bank)[0][:2]
    bank = _bank(n_subarrays=2)
    lanes, stage, needed = pt_bank.plan_queue(queue)
    wave = [0]
    states, ct, entries = bank._pack_wave(queue, wave, lanes, {})
    out = cu.replay(torch.from_numpy(states.view(np.int32)),
                    ct).numpy().view(np.uint32)
    results, planes = [None, None], {}
    bank._harvest_out(queue, entries, out, planes, needed, results)
    assert (0, 0) in planes
    want = _bank(n_subarrays=2).dispatch(queue[:1])
    _assert_same(results[:1], want)
    np.testing.assert_array_equal(flatten_result(results[0])[0],
                                  flatten_result(want[0])[0])
