"""The chip tier on the port against the JAX package, on the CPU.

Mirrors ``tests/test_chip.py`` case by case at its sizes: the same seeded
queue goes through the reference's ``SimdramChip`` (its single-device
path, ``use_shard_map=False``) and the port's (``device="cpu"``), and
the results must be ``==``, bit for bit, and ``==`` the port's
``sequential_dispatch``; every modeled ``ChipStats`` field (all but the
wall clocks) must be ``==`` the reference's.  The reference's shard_map
cases become "``use_shard_map=True`` raises": the port runs a tier on
one card.  Then the chip's replay (one flattened launch a round) and its
fault wrapper: stuck-only dispatches ``==`` the reference, ``FaultStats``
included, and flips that agree with the reference in distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import bank as ref_bank
from repro.core import chip as ref_chip
from repro.core import control_unit as ref_cu
from repro.core import fault as ref_fault
from repro.core.isa import SimdramDevice as RefDevice
from repro.core.timing import DramConfig as RefConfig
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.chip import (ChipStats, SimdramChip, partition_queue,
                                   sequential_dispatch)
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.core.isa import SimdramDevice, compile_op
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.timing import DramConfig, uprogram_latency_s

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


def _both(build, n_banks=4, n_subarrays=2, style="mig", **kw):
    """``build(mod)`` makes the same queue for either package.  Port chip
    == reference chip == port sequential per-bank dispatch; modeled stats
    == the reference's, chip and banks."""
    ref = ref_chip.SimdramChip(n_banks=n_banks, n_subarrays=n_subarrays,
                               style=style, use_shard_map=False, **kw)
    port = SimdramChip(n_banks=n_banks, n_subarrays=n_subarrays,
                       style=style, device="cpu", **kw)
    want = ref.dispatch(build(ref_bank))
    got = port.dispatch(build(pt_bank))
    _assert_same(got, want)
    seq, banks = sequential_dispatch(build(pt_bank), n_banks=n_banks,
                                     n_subarrays=n_subarrays, style=style,
                                     device="cpu")
    _assert_same(got, seq)
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert list(port.stats.as_dict()) == list(ref.stats.as_dict())
    for pb, rb in zip(port.banks, ref.banks):
        assert _modeled(pb.stats) == _modeled(rb.stats)
    return port, ref, banks, got


def _oracle(ins):
    spec = get_op(ins.op, ins.n_bits)
    ops = [np.asarray(o).astype(np.uint64) for o in ins.operands]
    return [np.asarray(o).astype(np.int64) & ((1 << w) - 1)
            for o, w in zip(spec.oracle(*ops), spec.out_bits)]


# --- bit-exactness --------------------------------------------------------

@pytest.mark.parametrize("style", ["mig", "aig"])
def test_chip_matches_reference_all_ops(style):
    """All 16 ops in one mixed queue, both styles."""
    def build(mod):
        rng = np.random.default_rng({"mig": 0, "aig": 1}[style])
        return [_rand_instr(mod, rng, op, 8, lanes=32) for op in ALL_OPS]

    chip, _, _, got = _both(build, style=style)
    assert chip.stats.bbops == len(ALL_OPS)
    assert chip.stats.elements == 32 * len(ALL_OPS)
    assert chip.stats.bank_programs.sum() == len(ALL_OPS)
    for ins, r in zip(build(pt_bank), got):
        spec = get_op(ins.op, ins.n_bits)
        for g, e, w in zip(_values(r), _oracle(ins), spec.out_bits):
            np.testing.assert_array_equal(g.astype(np.int64)
                                          & ((1 << w) - 1), e)


@given(st.integers(2, 6), st.integers(1, 3), st.integers(1, 3),
       st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_chip_property_random_queues(n_bits, n_banks, n_subarrays, seed):
    """Random op mixes / widths / lane counts / geometries: port chip ==
    reference chip == sequential per-bank == the grouped bank."""
    def build(mod):
        rng = np.random.default_rng(seed)
        ops = ("addition", "subtraction", "min", "max", "greater", "relu")
        queue = []
        for _ in range(int(rng.integers(1, 9))):
            op = ops[int(rng.integers(0, len(ops)))]
            lanes = int(rng.integers(1, 70))
            signed = bool(rng.integers(0, 2)) and op != "greater"
            queue.append(_rand_instr(mod, rng, op, n_bits, lanes=lanes,
                                     signed_out=signed))
        return queue

    _, _, _, got = _both(build, n_banks=n_banks, n_subarrays=n_subarrays)
    grouped = pt_bank.Bank(n_subarrays=n_subarrays, fuse=False, device="cpu")
    _assert_same(got, grouped.dispatch(build(pt_bank)))


def _chain(mod):
    rng = np.random.default_rng(2)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    z = rng.integers(0, 1 << 16, LANES).astype(np.uint64)
    kw = {"device": "cpu"} if mod is pt_bank else {}
    vo = mod.VerticalOperand.from_values(x, 8, **kw)
    return [
        mod.BbopInstr("multiplication", (x, y), 8),
        mod.BbopInstr("addition", (mod.Ref(0), z), 16),
        mod.BbopInstr("relu", (mod.Ref(1),), 16, keep_vertical=True),
        mod.BbopInstr("addition", (vo, y), 8),
    ], (x, y, z)


def test_chip_chain_with_vertical_operands():
    """Ref chains + a user VerticalOperand + keep_vertical: forwarded
    hops are counted in ChipStats as the reference counts them."""
    chip, _, _, got = _both(lambda mod: _chain(mod)[0])
    x, y, z = _chain(pt_bank)[1]
    want = (x * y + z) & 0xFFFF
    np.testing.assert_array_equal(
        got[2].to_values() & 0xFFFF, np.where(want >= 1 << 15, 0, want))
    assert chip.stats.transpositions_skipped == 4
    assert chip.stats.transpose_s_saved > 0


# --- scheduler ------------------------------------------------------------

def _chains(mod):
    rng = np.random.default_rng(3)
    queue = []
    for _ in range(6):     # six 3-instruction chains
        base = len(queue)
        queue.append(_rand_instr(mod, rng, "multiplication", 8))
        queue.append(mod.BbopInstr(
            "addition", (mod.Ref(base), queue[base].operands[0]), 8))
        queue.append(mod.BbopInstr("relu", (mod.Ref(base + 1),), 8))
    return queue


def test_ref_chains_stay_bank_local():
    """The partitioner keeps Ref-connected components on one bank and
    assigns every instruction where the reference does."""
    queue = _chains(pt_bank)
    lanes, _, _ = pt_bank.plan_queue(queue)
    bank_of = partition_queue(queue, list(range(len(queue))), lanes, 4)
    rq = _chains(ref_bank)
    assert bank_of == ref_chip.partition_queue(rq, list(range(len(rq))),
                                               lanes, 4)
    for base in range(0, len(queue), 3):
        assert bank_of[base] == bank_of[base + 1] == bank_of[base + 2]
    counts = np.bincount([bank_of[i] for i in range(len(queue))],
                         minlength=4)
    assert counts.max() == 6 and counts.min() == 3
    _both(_chains)


def test_lpt_balances_equal_components():
    def build(mod):
        rng = np.random.default_rng(4)
        return [_rand_instr(mod, rng, "addition", 8) for _ in range(8)]

    chip, _, _, _ = _both(build)
    np.testing.assert_array_equal(chip.stats.bank_programs, [2, 2, 2, 2])
    assert chip.stats.imbalance == pytest.approx(1.0)
    assert np.allclose(chip.stats.utilization, chip.stats.utilization[0])


def test_chip_latency_models_concurrent_banks():
    """N identical instructions on N banks cost ONE program latency,
    while the sequential baseline pays N times."""
    def build(mod):
        rng = np.random.default_rng(5)
        return [_rand_instr(mod, rng, "addition", 8) for _ in range(4)]

    chip, _, banks, _ = _both(build, n_banks=4, n_subarrays=1)
    _, up = compile_op("addition", 8)
    assert chip.stats.rounds == 1
    assert chip.stats.batches == 4
    assert chip.stats.latency_s == pytest.approx(uprogram_latency_s(up))
    _, rbanks = ref_chip.sequential_dispatch(build(ref_bank), n_banks=4,
                                             n_subarrays=1)
    assert [b.stats.latency_s for b in banks] == \
        [b.stats.latency_s for b in rbanks]
    assert sum(b.stats.latency_s for b in banks) == pytest.approx(
        4 * uprogram_latency_s(up))


def test_chip_stats_extend_bank_stats():
    def build(mod):
        rng = np.random.default_rng(6)
        return [_rand_instr(mod, rng, "addition", 8),
                _rand_instr(mod, rng, "greater", 8)]

    chip, _, _, _ = _both(build)
    assert isinstance(chip.stats, ChipStats)
    d = chip.stats.as_dict()
    for key in ("bbops", "batches", "fused_batches", "latency_s",
                "energy_nj", "pack_wall_s", "wall_s", "n_banks", "rounds",
                "bank_busy_s", "bank_programs", "utilization", "imbalance"):
        assert key in d, key
    assert d["n_banks"] == 4
    assert d["wall_s"] > 0 and d["pack_wall_s"] > 0
    assert d["latency_s"] > 0
    assert chip.stats.throughput_gops > 0
    assert sum(b.stats.bbops for b in chip.banks) == 2


# --- edge cases -----------------------------------------------------------

def test_empty_and_zero_lane_chip_queues():
    chip = SimdramChip(n_banks=2, n_subarrays=2, device="cpu")
    assert chip.dispatch([]) == []
    assert chip.stats.rounds == 0 and chip.stats.bbops == 0
    assert chip.stats.latency_s == 0.0

    def empties(mod):
        e = np.zeros(0, np.uint64)
        return [mod.BbopInstr("addition", (e, e), 8),
                mod.BbopInstr("relu", (mod.Ref(0),), 8),
                mod.BbopInstr("division", (e, e), 8),
                mod.BbopInstr("abs", (e,), 8, keep_vertical=True)]

    out = chip.dispatch(empties(pt_bank))
    assert np.asarray(out[0]).shape == (0,)
    assert np.asarray(out[1]).shape == (0,)
    assert all(np.asarray(o).shape == (0,) for o in out[2])
    assert isinstance(out[3], pt_bank.VerticalOperand) and out[3].lanes == 0
    assert chip.stats.rounds == 0 and chip.stats.latency_s == 0.0
    assert chip.stats.bbops == 4
    ref = ref_chip.SimdramChip(n_banks=2, n_subarrays=2, use_shard_map=False)
    ref.dispatch(empties(ref_bank))
    assert _modeled(chip.stats) == _modeled(ref.stats)

    def mixed(mod):
        rng = np.random.default_rng(7)
        e = np.zeros(0, np.uint64)
        return [_rand_instr(mod, rng, "addition", 8),
                mod.BbopInstr("addition", (e, e), 8),
                _rand_instr(mod, rng, "greater", 8)]

    chip2, _, _, rm = _both(mixed, n_banks=2)
    assert np.asarray(rm[1]).shape == (0,)
    assert chip2.stats.bank_programs.sum() == 2


def test_chip_bbop_spans_banks():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, 1000)
    y = rng.integers(0, 256, 1000)
    chip = SimdramChip(n_banks=4, n_subarrays=2, device="cpu")
    ref = ref_chip.SimdramChip(n_banks=4, n_subarrays=2, use_shard_map=False)
    got = chip.bbop("addition", x, y, n_bits=8)
    np.testing.assert_array_equal(got, ref.bbop("addition", x, y, n_bits=8))
    want = get_op("addition", 8).oracle(
        x.astype(np.uint64), y.astype(np.uint64))[0]
    np.testing.assert_array_equal(
        got.astype(np.int64) & 0xFF, want.astype(np.int64) & 0xFF)
    assert chip.stats.rounds == 1
    assert chip.stats.bank_programs.sum() == 8
    assert _modeled(chip.stats) == _modeled(ref.stats)


def test_device_chip_backend():
    """SimdramDevice(backend="chip") routes bbops and queue dispatch
    through the chip engine, with per-call accounting equal to the
    reference's."""
    dev = SimdramDevice(cfg=DramConfig(n_banks=2, subarrays_per_bank=2),
                        backend="chip", device="cpu")
    ref = RefDevice(cfg=RefConfig(n_banks=2, subarrays_per_bank=2),
                    backend="chip")
    rng = np.random.default_rng(9)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    got = dev.bbop("addition", x, y, n_bits=8)
    np.testing.assert_array_equal(got, ref.bbop("addition", x, y, n_bits=8))
    np.testing.assert_array_equal(np.asarray(got) & 0xFF, (x + y) & 0xFF)
    out = dev.dispatch([pt_bank.BbopInstr("addition", (x, y), 8),
                        pt_bank.BbopInstr("relu", (pt_bank.Ref(0),), 8)])
    want = (x + y) & 0xFF
    np.testing.assert_array_equal(
        np.asarray(out[1]) & 0xFF, np.where(want >= 128, 0, want))
    ref.dispatch([ref_bank.BbopInstr("addition", (x, y), 8),
                  ref_bank.BbopInstr("relu", (ref_bank.Ref(0),), 8)])
    assert dev.chip().n_banks == 2
    assert dev.totals()["calls"] == 3
    assert dev.chip().stats.transpositions_skipped == 1
    assert [vars(c) for c in dev.calls] == [vars(c) for c in ref.calls]
    assert _modeled(dev.chip().stats) == _modeled(ref.chip().stats)


def test_chip_validation():
    with pytest.raises(ValueError):
        SimdramChip(n_banks=0, device="cpu")
    with pytest.raises(ValueError):
        SimdramChip(n_banks=2, packing="nope", device="cpu")


# --- the executor: one card ------------------------------------------------

def test_single_device_executor_and_shard_map_raises():
    """The port's executor is the reference's single-device path (no
    mesh, not sharded); asking for shard_map or a mesh raises."""
    chip = SimdramChip(n_banks=4, n_subarrays=2, device="cpu")
    assert not chip.executor.sharded and chip.executor.mesh is None
    assert chip.executor.describe() == {"sharded": False, "devices": 1,
                                        "axes": []}
    with pytest.raises(ValueError, match="shard_map requested"):
        SimdramChip(n_banks=4, n_subarrays=2, use_shard_map=True,
                    device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SimdramChip(n_banks=4, n_subarrays=2, mesh=object(), device="cpu")
    ref = ref_chip.SimdramChip(n_banks=4, n_subarrays=2)
    assert ref.executor.sharded == chip.executor.sharded


def test_one_replay_per_round_and_nothing_rebuilt(monkeypatch):
    """Every stacked round is one flattened replay over all (bank,
    subarray) units; a repeated dispatch builds no table."""
    calls = []
    replay = cu.replay

    def counting(states, tables):
        calls.append(tuple(states.shape))
        return replay(states, tables)

    monkeypatch.setattr(cu, "replay", counting)

    def build(mod):
        rng = np.random.default_rng(10)
        q = [_rand_instr(mod, rng, op, w)
             for op in ("addition", "multiplication", "greater", "min")
             for w in (8, 16)]
        q.append(mod.BbopInstr("relu", (mod.Ref(1),), 16,
                               keep_vertical=True))
        return q

    chip = SimdramChip(n_banks=4, n_subarrays=2, device="cpu")
    chip.dispatch(build(pt_bank))
    assert len(calls) == chip.stats.rounds > 1
    assert all(s[0] == 8 for s in calls)
    chip.reset_stats()
    misses = cu.TABLE_CACHE.stats()["misses"]
    _assert_same(chip.dispatch(build(pt_bank)), ref_chip.SimdramChip(
        n_banks=4, n_subarrays=2, use_shard_map=False).dispatch(
            build(ref_bank)))
    assert cu.TABLE_CACHE.stats()["misses"] == misses


# --- the chip's replays ------------------------------------------------------

def _round(seed, n_banks=3, n_subs=2, n_words=3):
    rng = np.random.default_rng(seed)
    ops = [("addition", 8), ("multiplication", 8), ("greater", 16),
           ("min", 8), ("relu", 8), ("subtraction", 16)]
    tabs = [ref_bank.cached_table(op, w)[2] for op, w in ops]
    width = max(t.shape[0] for t in tabs)
    tables = np.stack([ref_cu.pad_command_table(t, width) for t in tabs])
    tables = tables[: n_banks * n_subs].reshape(n_banks, n_subs, width, 13)
    states = rng.integers(0, 2**32, (n_banks, n_subs, 64, n_words),
                          dtype=np.uint32)
    return states, tables, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_chip_replay_equals_reference(seed):
    states, tables, _ = _round(seed)
    want = np.asarray(ref_cu.chip_replay(jnp.asarray(states),
                                         jnp.asarray(tables)))
    got = cu.chip_replay(_t(states), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    flat = cu.CommandTables(torch.from_numpy(tables.reshape(6, -1, 13)),
                            cu.command_schedule(tables.reshape(6, -1, 13)))
    got2 = cu.chip_batched_interpreter("cpu")(states, flat)
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), want)


@pytest.mark.parametrize("p_flip", [0.0, 1.0])
def test_faulty_chip_replay_equals_reference(p_flip):
    """At p_flip 0 and 1 the reference draws no random bit: the
    flattened K6 plain version equals its vmap, flip counts included."""
    states, tables, rng = _round(2)
    n_words = states.shape[-1]
    keys = rng.integers(0, 2**32, (3, 2, 2), dtype=np.uint32)
    s0 = (rng.integers(0, 2**32, (3, 2, n_words), dtype=np.uint32)
          & rng.integers(0, 2**32, (3, 2, n_words), dtype=np.uint32))
    s1 = (rng.integers(0, 2**32, (3, 2, n_words), dtype=np.uint32)
          & rng.integers(0, 2**32, (3, 2, n_words), dtype=np.uint32) & ~s0)
    dead = np.zeros((3, 2), bool)
    want, want_n = ref_cu.faulty_chip_replay(
        *(jnp.asarray(a) for a in (states, tables, keys, s0, s1, dead)),
        np.float32(p_flip))
    got, got_n = cu.faulty_chip_batched_interpreter("cpu")(
        states, tables, keys, s0, s1, dead, p_flip)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(),
                                  np.asarray(want_n).astype(np.int64))
    assert tuple(got_n.shape) == (3, 2)


def test_tier_replays_reject_misfit_tables():
    states, tables, _ = _round(3)
    with pytest.raises(ValueError, match="unit axes"):
        cu.chip_replay(_t(states), torch.from_numpy(tables[:2]))
    with pytest.raises(ValueError, match="unit axes"):
        cu.chip_replay(_t(states[0]), torch.from_numpy(tables[0]))


# --- the fault wrapper --------------------------------------------------------

def _small_queue(mod, seed=3, lanes=64):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, lanes).astype(np.uint64)
    b = rng.integers(0, 256, lanes).astype(np.uint64)
    return [mod.BbopInstr("addition", (a, b), 8),
            mod.BbopInstr("min", (a, b), 8),
            mod.BbopInstr("multiplication", (mod.Ref(0), b), 8)]


def _dispatch_or_exhaust(eng, queue, exc):
    try:
        return "ok", eng.dispatch(queue)
    except exc as e:
        return "exhausted", e.context()


@pytest.mark.parametrize("kw", [
    {"stuck_lane_rate": 0.02, "spare_lanes": 2, "seed": 13},
    {"stuck_lane_rate": 0.05, "spare_lanes": 1, "seed": 3},
    {"stuck_lane_rate": 0.05, "spare_lanes": 0, "seed": 7},
])
def test_stuck_only_chip_dispatch_equals_reference(kw):
    """With p_flip = 0 and no dead unit nothing is drawn with
    jax.random: results, FaultStats, ChipStats and the blacklists are
    ``==`` the reference's."""
    model = dict(p_flip=0.0, **kw)
    ref = ref_chip.SimdramChip(n_banks=2, n_subarrays=2, use_shard_map=False,
                               fault=ref_fault.FaultModel(**model))
    port = SimdramChip(n_banks=2, n_subarrays=2, device="cpu",
                       fault=FaultModel(**model))
    want = _dispatch_or_exhaust(ref, _small_queue(ref_bank),
                                ref_fault.FaultExhaustedError)
    got = _dispatch_or_exhaust(port, _small_queue(pt_bank),
                               FaultExhaustedError)
    assert got[0] == want[0]
    if got[0] == "ok":
        _assert_same(got[1], want[1])
    else:
        assert got[1] == want[1]
        assert got[1]["tier"] == "chip"
    assert port.stats.faults.as_dict() == ref.stats.faults.as_dict()
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert [b._blacklist for b in port.banks] == \
        [b._blacklist for b in ref.banks]


def test_chip_tier_flips_bit_exact():
    """Mirror of the reference's chip-tier fault case: p_flip 1e-4, one
    spare lane: faults injected, detected, and the results exact."""
    def queue(mod):
        rng = np.random.default_rng(0)
        a, b = (rng.integers(0, 256, 300).astype(np.uint64)
                for _ in range(2))
        return [mod.BbopInstr("addition", (a, b), 8),
                mod.BbopInstr("multiplication", (mod.Ref(0), b), 8),
                mod.BbopInstr("greater", (a, b), 8)]

    clean = SimdramChip(n_banks=4, n_subarrays=4,
                        device="cpu").dispatch(queue(pt_bank))
    chip = SimdramChip(n_banks=4, n_subarrays=4, device="cpu",
                       fault=FaultModel(p_flip=1e-4, spare_lanes=1, seed=5))
    _assert_same(chip.dispatch(queue(pt_bank)), clean)
    fs = chip.stats.faults
    assert fs.injected > 0 and fs.detected > 0 and fs.overhead_s > 0


def _injected_single_run(tier_mod, make, p, seed, exc):
    """``stats.faults.injected`` of ONE replay of one instruction (no
    retry, no redispatch)."""
    eng = make(p, seed)
    lanes = np.arange(512, dtype=np.uint64) % np.uint64(256)
    try:
        eng.dispatch([tier_mod.BbopInstr("multiplication", (lanes, lanes),
                                         8)])
    except exc:
        pass
    return eng.stats.faults.injected


def test_chip_flips_agree_with_reference_in_distribution():
    """The bits drawn per attempt are the same count in both packages
    (every AP command of every unit, 32 a word); the flips injected at
    p = 1e-3, pooled over seeds, sit within 6 standard deviations of
    that count times p in both."""
    def port(p, seed):
        return SimdramChip(n_banks=2, n_subarrays=1, device="cpu",
                           fault=FaultModel(p_flip=p, spare_lanes=1,
                                            seed=seed, max_retries=0,
                                            max_redispatches=0))

    def ref(p, seed):
        return ref_chip.SimdramChip(
            n_banks=2, n_subarrays=1, use_shard_map=False,
            fault=ref_fault.FaultModel(p_flip=p, spare_lanes=1, seed=seed,
                                       max_retries=0, max_redispatches=0))

    n_draws = 2 * _injected_single_run(pt_bank, port, 0.5, 0,
                                       FaultExhaustedError)
    n_ref = 2 * _injected_single_run(ref_bank, ref, 0.5, 0,
                                     ref_fault.FaultExhaustedError)
    assert n_draws > 10_000
    assert abs(n_draws - n_ref) < 6 * np.sqrt(n_draws) + 10
    p = 1e-3
    for make, mod, exc, runs in ((port, pt_bank, FaultExhaustedError, 8),
                                 (ref, ref_bank,
                                  ref_fault.FaultExhaustedError, 4)):
        pooled = sum(_injected_single_run(mod, make, p, s, exc)
                     for s in range(runs))
        mean = runs * n_draws * p
        sd = np.sqrt(runs * n_draws * p * (1 - p))
        assert abs(pooled - mean) < 6 * sd + 10, (mod.__name__, pooled, mean)


def test_dead_banks_blacklisted_and_remapped_like_reference():
    """Dead subarrays: garbage comes from Philox here and jax.random in
    the reference, but either way the vote cannot decide, the same
    (bank, subarray) units are retired and the repacked results are
    exact."""
    model = dict(p_flip=0.0, dead_unit_rate=0.4, spare_lanes=1, seed=11)
    clean = SimdramChip(n_banks=2, n_subarrays=2,
                        device="cpu").dispatch(_small_queue(pt_bank))
    port = SimdramChip(n_banks=2, n_subarrays=2, device="cpu",
                       fault=FaultModel(**model))
    ref = ref_chip.SimdramChip(n_banks=2, n_subarrays=2, use_shard_map=False,
                               fault=ref_fault.FaultModel(**model))
    assert any(b._fault_rt.dead.any() for b in port.banks)
    got = port.dispatch(_small_queue(pt_bank))
    _assert_same(got, clean)
    _assert_same(got, ref.dispatch(_small_queue(ref_bank)))
    fs, rfs = port.stats.faults, ref.stats.faults
    assert fs.redispatches == rfs.redispatches > 0
    assert fs.remapped == rfs.remapped > 0
    assert [b._blacklist for b in port.banks] == \
        [b._blacklist for b in ref.banks]


def test_chip_exhaustion_raises_with_bank_coordinates():
    chip = SimdramChip(n_banks=2, n_subarrays=2, device="cpu",
                       fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                        spare_lanes=1, seed=1,
                                        max_redispatches=1))
    with pytest.raises(FaultExhaustedError) as info:
        chip.dispatch(_small_queue(pt_bank))
    assert info.value.tier == "chip"
    assert info.value.blacklist
    assert all(len(u) == 2 for u in info.value.blacklist)


def test_blacklist_units_takes_bank_subarray_pairs():
    chip = SimdramChip(n_banks=2, n_subarrays=2, device="cpu",
                       fault=FaultModel(p_flip=0.0, seed=1))
    assert chip._blacklist_units([(0, 1), (1, 0), (0, 1)]) == 2
    assert [b._blacklist for b in chip.banks] == [{1}, {0}]
    assert chip._blacklist_units([(1, 0)]) == 0
