"""The rank tier on the port against the JAX package, on the CPU.

Mirrors ``tests/test_rank.py`` case by case at its sizes: the same seeded
queue goes through the reference's ``SimdramRank``
(``use_shard_map=False``) and the port's (``device="cpu"``); results must
be ``==``, bit for bit, and ``==`` the port's
``sequential_rank_dispatch``, and every modeled ``RankStats`` field
``==`` the reference's.  The reference's retrace count becomes the
table cache's and the kernel builds' (nothing rebuilt on a repeat), and
over the one CPU ``use_shard_map=True`` finds no multi-device mesh and
raises (the split cases are in ``tests/test_torch_pum_sharded.py``).
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import bank as ref_bank
from repro.core import chip as ref_chip
from repro.core import control_unit as ref_cu
from repro.core import rank as ref_rank
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.chip import partition_queue
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.rank import (RankStats, SimdramRank,
                                   sequential_rank_dispatch)

LANES = 48
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


def _engines(**geo):
    return (ref_rank.SimdramRank(use_shard_map=False, **geo),
            SimdramRank(device="cpu", **geo))


def _both(build, n_channels=2, n_chips=2, n_banks=2, n_subarrays=2,
          style="mig"):
    """Port rank == reference rank == port sequential per-channel
    dispatch; modeled stats == the reference's, rank and channels."""
    geo = dict(n_channels=n_channels, n_chips=n_chips, n_banks=n_banks,
               n_subarrays=n_subarrays, style=style)
    ref, port = _engines(**geo)
    want = ref.dispatch(build(ref_bank))
    got = port.dispatch(build(pt_bank))
    _assert_same(got, want)
    seq, channels = sequential_rank_dispatch(build(pt_bank), device="cpu",
                                             **geo)
    _assert_same(got, seq)
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert list(port.stats.as_dict()) == list(ref.stats.as_dict())
    for pc, rc in zip(port.channels, ref.channels):
        assert _modeled(pc.stats) == _modeled(rc.stats)
    return port, ref, channels, got


# --- bit-exactness --------------------------------------------------------

@pytest.mark.parametrize("style", ["mig", "aig"])
def test_rank_matches_reference_all_ops(style):
    def build(mod):
        rng = np.random.default_rng({"mig": 0, "aig": 1}[style])
        return [_rand_instr(mod, rng, op, 8, lanes=32) for op in ALL_OPS]

    rank, _, _, _ = _both(build, style=style)
    assert rank.stats.bbops == len(ALL_OPS)
    assert rank.stats.elements == 32 * len(ALL_OPS)
    assert rank.stats.channel_programs.sum() == len(ALL_OPS)
    assert sum(ch.stats.bbops for ch in rank.channels) == len(ALL_OPS)


@given(st.integers(2, 6), st.integers(1, 3), st.integers(1, 2),
       st.integers(0, 10_000))
@settings(max_examples=6, deadline=None)
def test_rank_property_random_queues(n_bits, n_channels, n_chips, seed):
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

    _both(build, n_channels=n_channels, n_chips=n_chips)


def test_rank_chain_with_vertical_operands():
    def build(mod):
        rng = np.random.default_rng(2)
        x, y = (rng.integers(0, 256, LANES).astype(np.uint64)
                for _ in range(2))
        z = rng.integers(0, 1 << 16, LANES).astype(np.uint64)
        kw = {"device": "cpu"} if mod is pt_bank else {}
        vo = mod.VerticalOperand.from_values(x, 8, **kw)
        return [
            mod.BbopInstr("multiplication", (x, y), 8),
            mod.BbopInstr("addition", (mod.Ref(0), z), 16),
            mod.BbopInstr("relu", (mod.Ref(1),), 16, keep_vertical=True),
            mod.BbopInstr("addition", (vo, y), 8),
        ]

    rank, _, _, got = _both(build)
    q = build(pt_bank)
    x, y = q[0].operands
    z = q[1].operands[1]
    want = (x * y + z) & 0xFFFF
    np.testing.assert_array_equal(
        got[2].to_values() & 0xFFFF, np.where(want >= 1 << 15, 0, want))
    assert rank.stats.transpositions_skipped == 4
    assert rank.stats.transpose_s_saved > 0


def test_ref_chains_stay_channel_local():
    def build(mod):
        rng = np.random.default_rng(3)
        queue = []
        for _ in range(5):
            base = len(queue)
            queue.append(_rand_instr(mod, rng, "multiplication", 8,
                                     lanes=20))
            queue.append(mod.BbopInstr("relu", (mod.Ref(base),), 8))
            queue.append(mod.BbopInstr("abs", (mod.Ref(base + 1),), 8))
        return queue

    queue = build(pt_bank)
    lanes, _, _ = pt_bank.plan_queue(queue)
    channel_of = partition_queue(queue, list(range(len(queue))), lanes, 2)
    rq = build(ref_bank)
    assert channel_of == ref_chip.partition_queue(
        rq, list(range(len(rq))), lanes, 2)
    for base in range(0, len(queue), 3):
        assert len({channel_of[base + j] for j in range(3)}) == 1
    _both(build)


# --- cost model -----------------------------------------------------------

def test_rank_latency_models_concurrent_channels():
    def build(mod):
        rng = np.random.default_rng(5)
        return [_rand_instr(mod, rng, "addition", 8) for _ in range(8)]

    rank, _, channels, _ = _both(build, n_channels=2, n_chips=2)
    seq_s = sum(ch.stats.latency_s for ch in channels)
    assert rank.stats.super_rounds >= 1
    assert rank.stats.latency_s < seq_s
    assert rank.stats.latency_s == pytest.approx(seq_s / 2)
    np.testing.assert_allclose(
        rank.stats.channel_busy_s,
        [ch.stats.latency_s for ch in rank.channels])


def test_rank_transfer_accounting():
    def build(mod):
        rng = np.random.default_rng(6)
        return [_rand_instr(mod, rng, "addition", 8, lanes=64)
                for _ in range(8)]

    rank, _, _, _ = _both(build)
    st_ = rank.stats
    assert st_.transfer_bytes > 0
    assert st_.transfer_s == st_.transfer_h2d_s + st_.transfer_d2h_s
    assert 0.0 <= st_.transfer_overlapped_s <= st_.transfer_s
    assert st_.exposed_transfer_s == (st_.transfer_s
                                      - st_.transfer_overlapped_s)
    assert st_.total_latency_s >= st_.latency_s + st_.exposed_transfer_s
    assert all(ch.stats.transfer_bytes == 0 for ch in rank.channels)


# --- stats surface --------------------------------------------------------

def test_rank_stats_extend_channel_stats():
    def build(mod):
        rng = np.random.default_rng(8)
        return [_rand_instr(mod, rng, "addition", 8),
                _rand_instr(mod, rng, "greater", 8)]

    rank, _, _, _ = _both(build)
    assert isinstance(rank.stats, RankStats)
    d = rank.stats.as_dict()
    for key in ("bbops", "batches", "latency_s", "energy_nj", "wall_s",
                "super_rounds", "transfer_bytes", "transfer_s",
                "transfer_h2d_s", "transfer_d2h_s", "transfer_overlapped_s",
                "exposed_transfer_s", "transfer_bound", "crossover_chips",
                "chip_busy_s", "chip_programs", "utilization", "imbalance",
                "n_channels", "channel_busy_s", "channel_programs",
                "channel_imbalance"):
        assert key in d, key
    assert d["n_channels"] == 2
    assert d["n_chips"] == 4
    assert len(d["channel_busy_s"]) == 2
    assert len(d["chip_busy_s"]) == 4
    assert d["latency_s"] > 0 and d["wall_s"] > 0
    assert rank.stats.channel_imbalance >= 1.0
    rank.reset_stats()
    assert rank.stats.latency_s == 0.0
    assert not rank.stats.channel_busy_s.any()


# --- edge cases -----------------------------------------------------------

def test_empty_and_zero_lane_rank_queues():
    rank = SimdramRank(device="cpu")
    assert rank.dispatch([]) == []
    assert rank.stats.super_rounds == 0 and rank.stats.bbops == 0
    e = np.zeros(0, np.uint64)
    out = rank.dispatch([pt_bank.BbopInstr("addition", (e, e), 8),
                         pt_bank.BbopInstr("relu", (pt_bank.Ref(0),), 8)])
    assert np.asarray(out[0]).shape == (0,)
    assert np.asarray(out[1]).shape == (0,)
    assert rank.stats.super_rounds == 0
    assert rank.stats.transfer_bytes == 0
    assert rank.stats.bbops == 2

    def mixed(mod):
        rng = np.random.default_rng(9)
        return [_rand_instr(mod, rng, "addition", 8),
                mod.BbopInstr("addition", (e, e), 8),
                _rand_instr(mod, rng, "greater", 8)]

    rank2, _, _, rm = _both(mixed)
    assert np.asarray(rm[1]).shape == (0,)
    assert rank2.stats.channel_programs.sum() == 2


def test_rank_bbop_spans_channels():
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, 1600)
    y = rng.integers(0, 256, 1600)
    ref, rank = _engines()
    got = rank.bbop("addition", x, y, n_bits=8)
    np.testing.assert_array_equal(got, ref.bbop("addition", x, y, n_bits=8))
    want = get_op("addition", 8).oracle(
        x.astype(np.uint64), y.astype(np.uint64))[0]
    np.testing.assert_array_equal(got.astype(np.int64) & 0xFF,
                                  want.astype(np.int64) & 0xFF)
    assert rank.stats.super_rounds == 1
    assert rank.stats.channel_programs.sum() == 16
    assert _modeled(rank.stats) == _modeled(ref.stats)


def test_rank_validation_and_isa_routing():
    from repro.core.isa import SimdramDevice as RefDevice
    from repro.core.timing import DDR4 as REF_DDR4
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DDR4
    with pytest.raises(ValueError):
        SimdramRank(n_channels=0, device="cpu")
    geo = dict(n_channels=2, n_chips=2, n_banks=2, subarrays_per_bank=2)
    dev = SimdramDevice(cfg=replace(DDR4, **geo), backend="rank",
                        device="cpu")
    ref = RefDevice(cfg=replace(REF_DDR4, **geo), backend="rank")
    x = np.arange(100, dtype=np.uint64) % 251
    y = (x * 7) % 251
    got = dev.bbop("addition", x, y, n_bits=8)
    np.testing.assert_array_equal(got, ref.bbop("addition", x, y, n_bits=8))
    want = get_op("addition", 8).oracle(x, y)[0]
    np.testing.assert_array_equal(got.astype(np.int64) & 0xFF,
                                  want.astype(np.int64) & 0xFF)
    assert dev.rank().stats.bbops > 0
    assert dev.calls and dev.calls[-1].op == "addition"
    assert [vars(c) for c in dev.calls] == [vars(c) for c in ref.calls]
    assert _modeled(dev.rank().stats) == _modeled(ref.rank().stats)
    bad = SimdramDevice(cfg=replace(DDR4, **geo), backend="rank",
                        device="cpu", fault=FaultModel(enabled=True, seed=0))
    with pytest.raises(ValueError, match="fault injection"):
        bad.bbop("addition", x, y, n_bits=8)


# --- nothing rebuilt on a repeat ----------------------------------------------

def test_rank_repeat_dispatch_builds_nothing(monkeypatch):
    """A repeated same-shape dispatch (the reference counts zero
    retraces) makes one replay a rank round, builds no kernel and
    re-encodes no table."""
    calls = []
    replay = cu.replay

    def counting(states, tables):
        calls.append(tuple(states.shape))
        return replay(states, tables)

    monkeypatch.setattr(cu, "replay", counting)
    rng = np.random.default_rng(12)
    rank = SimdramRank(device="cpu")
    rank.dispatch([_rand_instr(pt_bank, rng, "addition", 8)
                   for _ in range(4)])
    assert len(calls) == rank.stats.super_rounds >= 1
    assert all(s[0] == 16 for s in calls)
    k0, misses = cu.kernel_counts(), cu.TABLE_CACHE.stats()["misses"]
    rank.reset_stats()
    rank.dispatch([_rand_instr(pt_bank, rng, "addition", 8)
                   for _ in range(4)])
    assert cu.kernel_counts()["builds"] == k0["builds"]
    assert cu.TABLE_CACHE.stats()["misses"] == misses


# --- the executor: one device ----------------------------------------------

def test_rank_single_device_executor_and_shard_map_raises():
    """Over the one CPU the executor is the unsplit one:
    ``use_shard_map=True`` finds no multi-device mesh and raises, and a
    mesh that is not a ``Mesh`` raises."""
    rank = SimdramRank(device="cpu")
    assert not rank.executor.sharded and rank.executor.mesh is None
    with pytest.raises(ValueError, match="shard_map requested"):
        SimdramRank(use_shard_map=True, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SimdramRank(mesh=object(), device="cpu")


# --- the rank's replay ----------------------------------------------------

def test_rank_replay_equals_reference():
    rng = np.random.default_rng(0)
    ops = [("addition", 8), ("multiplication", 8), ("greater", 16),
           ("min", 8)]
    tabs = [ref_bank.cached_table(op, w)[2] for op, w in ops]
    width = max(t.shape[0] for t in tabs)
    tables = np.stack([ref_cu.pad_command_table(t, width)
                       for t in tabs * 4]).reshape(2, 2, 2, 2, width, 13)
    states = rng.integers(0, 2**32, (2, 2, 2, 2, 64, 3), dtype=np.uint32)
    want = np.asarray(ref_cu.rank_replay(jnp.asarray(states),
                                         jnp.asarray(tables)))
    got = cu.rank_replay(torch.from_numpy(states.view(np.int32)),
                         torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got2 = cu.rank_batched_interpreter("cpu")(states, tables)
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), want)


def test_kernel_schedule_raises_past_the_unit_limit():
    """K5 and K6 put a round's units on the grid's y axis: a round with
    more than 65,535 units raises instead of being cut."""
    states = torch.zeros((cu.KERNEL_MAX_UNITS + 1, 1, 1), dtype=torch.int32)
    tables = torch.zeros((1, 13), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 65535 units"):
        cu._kernel_schedule(states, tables, None)
    ok = cu._kernel_schedule(states[:cu.KERNEL_MAX_UNITS], tables, None)
    assert tuple(ok.shape) == (2, cu.KERNEL_MAX_UNITS)
