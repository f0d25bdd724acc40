"""The channel tier on the port against the JAX package, on the CPU.

Mirrors ``tests/test_channel.py`` case by case at its sizes: the same
seeded queue goes through the reference's ``SimdramChannel``
(``use_shard_map=False``) and the port's (``device="cpu"``); results
must be ``==``, bit for bit, and ``==`` the port's
``sequential_channel_dispatch``, and every modeled ``ChannelStats``
field — the transfer model's included — ``==`` the reference's.  The
shard_map cases become "``use_shard_map=True`` raises".  Then the
channel's replays (one flattened launch a super-round) and its fault
wrapper: stuck-only dispatches ``==`` the reference, ``FaultStats``
included, flips that agree in distribution, and ``(chip, bank, sid)``
blacklisting.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import bank as ref_bank
from repro.core import channel as ref_channel
from repro.core import chip as ref_chip
from repro.core import control_unit as ref_cu
from repro.core import fault as ref_fault
from repro.core.timing import DDR4 as REF_DDR4
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.channel import (ChannelStats, SimdramChannel,
                                      sequential_channel_dispatch)
from repro_torch.core.chip import partition_queue
from repro_torch.core.costmodel import transfer_crossover_chips
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.timing import DDR4, burst_rounded_bytes, host_transfer_s

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


def _engines(n_chips=2, n_banks=2, n_subarrays=2, cfg=None, **kw):
    ref = ref_channel.SimdramChannel(
        n_chips=n_chips, n_banks=n_banks, n_subarrays=n_subarrays,
        use_shard_map=False,
        **({"cfg": cfg[0]} if cfg else {}), **kw)
    port = SimdramChannel(
        n_chips=n_chips, n_banks=n_banks, n_subarrays=n_subarrays,
        device="cpu", **({"cfg": cfg[1]} if cfg else {}), **kw)
    return ref, port


def _both(build, n_chips=2, n_banks=2, n_subarrays=2, style="mig", **kw):
    """Port channel == reference channel == port sequential per-chip
    dispatch; modeled stats == the reference's, channel and chips."""
    ref, port = _engines(n_chips, n_banks, n_subarrays, style=style, **kw)
    want = ref.dispatch(build(ref_bank))
    got = port.dispatch(build(pt_bank))
    _assert_same(got, want)
    seq, chips = sequential_channel_dispatch(
        build(pt_bank), n_chips=n_chips, n_banks=n_banks,
        n_subarrays=n_subarrays, style=style, device="cpu")
    _assert_same(got, seq)
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert list(port.stats.as_dict()) == list(ref.stats.as_dict())
    for pc, rc in zip(port.chips, ref.chips):
        assert _modeled(pc.stats) == _modeled(rc.stats)
    return port, ref, chips, got


# --- bit-exactness --------------------------------------------------------

@pytest.mark.parametrize("style", ["mig", "aig"])
def test_channel_matches_reference_all_ops(style):
    def build(mod):
        rng = np.random.default_rng({"mig": 0, "aig": 1}[style])
        return [_rand_instr(mod, rng, op, 8, lanes=32) for op in ALL_OPS]

    channel, _, _, _ = _both(build, style=style)
    assert channel.stats.bbops == len(ALL_OPS)
    assert channel.stats.elements == 32 * len(ALL_OPS)
    assert channel.stats.chip_programs.sum() == len(ALL_OPS)
    assert sum(c.stats.bbops for c in channel.chips) == len(ALL_OPS)


@given(st.integers(2, 6), st.integers(1, 3), st.integers(1, 2),
       st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_channel_property_random_queues(n_bits, n_chips, n_banks, seed):
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

    _both(build, n_chips=n_chips, n_banks=n_banks)


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


def test_channel_chain_with_vertical_operands():
    channel, _, _, got = _both(lambda mod: _chain(mod)[0])
    x, y, z = _chain(pt_bank)[1]
    want = (x * y + z) & 0xFFFF
    np.testing.assert_array_equal(
        got[2].to_values() & 0xFFFF, np.where(want >= 1 << 15, 0, want))
    assert channel.stats.transpositions_skipped == 4
    assert channel.stats.transpose_s_saved > 0


# --- scheduler ------------------------------------------------------------

@given(st.integers(1, 4), st.integers(2, 5), st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_ref_chains_stay_chip_local(n_chips, chain_len, seed):
    """The chip partitioner never splits a Ref-connected component and
    places every instruction where the reference does."""
    def build(mod):
        rng = np.random.default_rng(seed)
        queue = []
        n_chains = int(rng.integers(1, 7))
        for _ in range(n_chains):
            base = len(queue)
            queue.append(_rand_instr(mod, rng, "multiplication", 8,
                                     lanes=int(rng.integers(1, 40))))
            for j in range(chain_len - 1):
                queue.append(mod.BbopInstr("relu", (mod.Ref(base + j),), 8))
        return queue, n_chains

    queue, n_chains = build(pt_bank)
    lanes, _, _ = pt_bank.plan_queue(queue)
    chip_of = partition_queue(queue, list(range(len(queue))), lanes, n_chips)
    rq, _ = build(ref_bank)
    assert chip_of == ref_chip.partition_queue(rq, list(range(len(rq))),
                                               lanes, n_chips)
    pos = 0
    for _ in range(n_chains):
        assert len({chip_of[pos + j] for j in range(chain_len)}) == 1
        pos += chain_len


def test_lpt_balances_equal_components():
    def build(mod):
        rng = np.random.default_rng(4)
        return [_rand_instr(mod, rng, "addition", 8) for _ in range(8)]

    channel, _, _, _ = _both(build, n_chips=2, n_banks=2)
    np.testing.assert_array_equal(channel.stats.chip_programs, [4, 4])
    assert channel.stats.imbalance == pytest.approx(1.0)
    assert np.allclose(channel.stats.utilization,
                       channel.stats.utilization[0])


def test_channel_latency_models_concurrent_chips():
    def build(mod):
        rng = np.random.default_rng(5)
        return [_rand_instr(mod, rng, "addition", 8) for _ in range(8)]

    channel, _, chips, _ = _both(build, n_chips=2, n_banks=2, n_subarrays=2)
    seq_s = sum(c.stats.latency_s for c in chips)
    assert channel.stats.super_rounds >= 1
    assert channel.stats.latency_s < seq_s
    assert channel.stats.latency_s == pytest.approx(seq_s / 2)
    _, rchips = ref_channel.sequential_channel_dispatch(
        build(ref_bank), n_chips=2, n_banks=2, n_subarrays=2)
    assert [_modeled(c.stats) for c in chips] == \
        [_modeled(c.stats) for c in rchips]


# --- transfer model -------------------------------------------------------

def test_transfer_monotone_in_bandwidth():
    ops = ("addition", "greater", "xor_red", "subtraction")
    prev = None
    for bw in (19.2, 9.6, 4.8, 1.2, 0.3):
        ref, channel = _engines(cfg=(replace(REF_DDR4, channel_bw_gbs=bw),
                                     replace(DDR4, channel_bw_gbs=bw)))

        def build(mod):
            rng = np.random.default_rng(6)
            return [_rand_instr(mod, rng, op, 8, lanes=2048) for op in ops]

        _assert_same(channel.dispatch(build(pt_bank)),
                     ref.dispatch(build(ref_bank)))
        assert _modeled(channel.stats) == _modeled(ref.stats)
        t = channel.stats.total_latency_s
        assert channel.stats.transfer_s == pytest.approx(
            host_transfer_s(channel.stats.transfer_bytes, channel.cfg))
        if prev is not None:
            assert t >= prev, f"latency dropped when bw shrank to {bw}"
        prev = t
    assert channel.stats.transfer_bound


def test_transfer_accounting_and_crossover():
    rng = np.random.default_rng(7)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    ref, channel = _engines()
    for eng, mod in ((channel, pt_bank), (ref, ref_bank)):
        eng.dispatch([
            mod.BbopInstr("multiplication", (x, y), 8),
            mod.BbopInstr("relu", (mod.Ref(0),), 16, keep_vertical=True),
        ])
    assert _modeled(channel.stats) == _modeled(ref.stats)
    raw = LANES * (8 + 8) // 8
    assert channel.stats.transfer_bytes == (
        burst_rounded_bytes(raw, channel.cfg)
        + burst_rounded_bytes(LANES * 16 // 8, channel.cfg))
    assert channel.stats.transfer_bytes >= LANES * (8 + 8 + 16) // 8
    st_ = channel.stats
    assert st_.transfer_s == st_.transfer_h2d_s + st_.transfer_d2h_s
    assert 0.0 <= st_.transfer_overlapped_s <= st_.transfer_s
    assert st_.exposed_transfer_s == (st_.transfer_s
                                      - st_.transfer_overlapped_s)
    assert st_.crossover_chips == pytest.approx(
        transfer_crossover_chips(float(st_.chip_busy_s.sum()),
                                 st_.exposed_transfer_s))
    assert st_.total_latency_s >= st_.latency_s + st_.exposed_transfer_s

    free = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device="cpu")
    vo = pt_bank.VerticalOperand.from_values(x, 8, device="cpu")
    free.dispatch([pt_bank.BbopInstr("relu", (vo,), 8, keep_vertical=True)])
    assert free.stats.transfer_bytes == 0
    assert free.stats.crossover_chips == float("inf")
    assert not free.stats.transfer_bound


# --- stats surface --------------------------------------------------------

def test_channel_stats_extend_bank_stats():
    def build(mod):
        rng = np.random.default_rng(8)
        return [_rand_instr(mod, rng, "addition", 8),
                _rand_instr(mod, rng, "greater", 8)]

    channel, _, _, _ = _both(build)
    assert isinstance(channel.stats, ChannelStats)
    d = channel.stats.as_dict()
    for key in ("bbops", "batches", "fused_batches", "latency_s",
                "energy_nj", "pack_wall_s", "wall_s", "n_chips", "n_banks",
                "super_rounds", "transfer_bytes", "transfer_s",
                "transfer_h2d_s", "transfer_d2h_s", "transfer_overlapped_s",
                "exposed_transfer_s", "transfer_bound", "crossover_chips",
                "chip_busy_s", "chip_programs", "utilization", "imbalance"):
        assert key in d, key
    assert d["n_chips"] == 2
    assert d["wall_s"] > 0 and d["pack_wall_s"] > 0
    assert d["latency_s"] > 0
    assert channel.stats.throughput_gops > 0


# --- edge cases -----------------------------------------------------------

def test_empty_and_zero_lane_channel_queues():
    channel = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                             device="cpu")
    assert channel.dispatch([]) == []
    assert channel.stats.super_rounds == 0 and channel.stats.bbops == 0
    assert channel.stats.latency_s == 0.0
    e = np.zeros(0, np.uint64)
    out = channel.dispatch([
        pt_bank.BbopInstr("addition", (e, e), 8),
        pt_bank.BbopInstr("relu", (pt_bank.Ref(0),), 8),
        pt_bank.BbopInstr("abs", (e,), 8, keep_vertical=True)])
    assert np.asarray(out[0]).shape == (0,)
    assert np.asarray(out[1]).shape == (0,)
    assert isinstance(out[2], pt_bank.VerticalOperand) and out[2].lanes == 0
    assert channel.stats.super_rounds == 0
    assert channel.stats.transfer_bytes == 0
    assert channel.stats.bbops == 3

    def mixed(mod):
        rng = np.random.default_rng(9)
        return [_rand_instr(mod, rng, "addition", 8),
                mod.BbopInstr("addition", (e, e), 8),
                _rand_instr(mod, rng, "greater", 8)]

    channel2, _, _, rm = _both(mixed)
    assert np.asarray(rm[1]).shape == (0,)
    assert channel2.stats.chip_programs.sum() == 2


def test_channel_bbop_spans_chips():
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, 1000)
    y = rng.integers(0, 256, 1000)
    ref, channel = _engines()
    got = channel.bbop("addition", x, y, n_bits=8)
    np.testing.assert_array_equal(got, ref.bbop("addition", x, y, n_bits=8))
    want = get_op("addition", 8).oracle(
        x.astype(np.uint64), y.astype(np.uint64))[0]
    np.testing.assert_array_equal(
        got.astype(np.int64) & 0xFF, want.astype(np.int64) & 0xFF)
    assert channel.stats.super_rounds == 1
    assert channel.stats.chip_programs.sum() == 8
    assert _modeled(channel.stats) == _modeled(ref.stats)


def test_channel_validation():
    with pytest.raises(ValueError):
        SimdramChannel(n_chips=0, device="cpu")
    with pytest.raises(ValueError):
        SimdramChannel(n_chips=2, packing="nope", device="cpu")


def test_device_channel_backend():
    from repro.core.isa import SimdramDevice as RefDevice
    from repro.core.timing import DramConfig as RefConfig
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DramConfig
    geo = dict(n_banks=2, subarrays_per_bank=2, n_chips=2)
    dev = SimdramDevice(cfg=DramConfig(**geo), backend="channel",
                        device="cpu")
    ref = RefDevice(cfg=RefConfig(**geo), backend="channel")
    rng = np.random.default_rng(12)
    x, y = (rng.integers(0, 256, LANES).astype(np.uint64) for _ in range(2))
    np.testing.assert_array_equal(dev.bbop("addition", x, y, n_bits=8),
                                  ref.bbop("addition", x, y, n_bits=8))
    _assert_same(
        dev.dispatch([pt_bank.BbopInstr("addition", (x, y), 8),
                      pt_bank.BbopInstr("relu", (pt_bank.Ref(0),), 8)]),
        ref.dispatch([ref_bank.BbopInstr("addition", (x, y), 8),
                      ref_bank.BbopInstr("relu", (ref_bank.Ref(0),), 8)]))
    assert dev.channel().n_chips == 2
    assert [vars(c) for c in dev.calls] == [vars(c) for c in ref.calls]
    assert _modeled(dev.channel().stats) == _modeled(ref.channel().stats)


# --- the executor: one card ------------------------------------------------

def test_single_device_executor_and_shard_map_raises():
    channel = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                             device="cpu")
    assert not channel.executor.sharded and channel.executor.mesh is None
    with pytest.raises(ValueError, match="shard_map requested"):
        SimdramChannel(n_chips=2, n_banks=2, use_shard_map=True,
                       device="cpu")
    with pytest.raises(ValueError, match="shard_map requested"):
        SimdramChannel(n_chips=2, n_banks=2, use_shard_map=True,
                       fault=FaultModel(p_flip=0.0), device="cpu")


def test_one_replay_per_super_round(monkeypatch):
    """The member chips never replay: every super-round is one
    flattened replay over all (chip, bank, subarray) units."""
    calls = []
    replay = cu.replay

    def counting(states, tables):
        calls.append(tuple(states.shape))
        return replay(states, tables)

    monkeypatch.setattr(cu, "replay", counting)

    def build(mod):
        rng = np.random.default_rng(11)
        q = [_rand_instr(mod, rng, op, w)
             for op in ("addition", "multiplication", "greater", "min")
             for w in (8, 16)]
        q.append(mod.BbopInstr("relu", (mod.Ref(1),), 16,
                               keep_vertical=True))
        return q

    ref, channel = _engines(n_chips=2, n_banks=4, n_subarrays=2)
    _assert_same(channel.dispatch(build(pt_bank)),
                 ref.dispatch(build(ref_bank)))
    assert len(calls) == channel.stats.super_rounds > 1
    assert all(s[0] == 16 for s in calls)
    assert all(c.stats.rounds > 0 for c in channel.chips)


# --- the channel's replays ----------------------------------------------------

def _super_round(seed):
    rng = np.random.default_rng(seed)
    ops = [("addition", 8), ("multiplication", 8), ("greater", 16),
           ("min", 8)]
    tabs = [ref_bank.cached_table(op, w)[2] for op, w in ops]
    width = max(t.shape[0] for t in tabs)
    tables = np.stack([ref_cu.pad_command_table(t, width) for t in tabs])
    tables = np.concatenate([tables, tables[::-1]]).reshape(
        2, 2, 2, width, 13)
    states = rng.integers(0, 2**32, (2, 2, 2, 64, 3), dtype=np.uint32)
    return states, tables, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_channel_replay_equals_reference():
    states, tables, _ = _super_round(0)
    want = np.asarray(ref_cu.channel_replay(jnp.asarray(states),
                                            jnp.asarray(tables)))
    got = cu.channel_replay(_t(states), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got2 = cu.channel_batched_interpreter("cpu")(states, tables)
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), want)


@pytest.mark.parametrize("p_flip", [0.0, 1.0])
def test_faulty_channel_replay_equals_reference(p_flip):
    states, tables, rng = _super_round(1)
    lead = states.shape[:3]
    keys = rng.integers(0, 2**32, lead + (2,), dtype=np.uint32)
    s0 = (rng.integers(0, 2**32, lead + (3,), dtype=np.uint32)
          & rng.integers(0, 2**32, lead + (3,), dtype=np.uint32))
    s1 = (rng.integers(0, 2**32, lead + (3,), dtype=np.uint32)
          & rng.integers(0, 2**32, lead + (3,), dtype=np.uint32) & ~s0)
    dead = np.zeros(lead, bool)
    want, want_n = ref_cu.faulty_channel_replay(
        *(jnp.asarray(a) for a in (states, tables, keys, s0, s1, dead)),
        np.float32(p_flip))
    got, got_n = cu.faulty_channel_batched_interpreter("cpu")(
        states, tables, keys, s0, s1, dead, p_flip)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(),
                                  np.asarray(want_n).astype(np.int64))


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


def _blacklists(channel):
    return [[b._blacklist for b in chip.banks] for chip in channel.chips]


@pytest.mark.parametrize("kw", [
    {"stuck_lane_rate": 0.02, "spare_lanes": 2, "seed": 13},
    {"stuck_lane_rate": 0.05, "spare_lanes": 1, "seed": 3},
    {"stuck_lane_rate": 0.05, "spare_lanes": 0, "seed": 7},
])
def test_stuck_only_channel_dispatch_equals_reference(kw):
    model = dict(p_flip=0.0, **kw)
    ref = ref_channel.SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                                     use_shard_map=False,
                                     fault=ref_fault.FaultModel(**model))
    port = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device="cpu",
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
        assert got[1]["tier"] == "channel"
    assert port.stats.faults.as_dict() == ref.stats.faults.as_dict()
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert _blacklists(port) == _blacklists(ref)


def test_channel_tier_flips_bit_exact():
    def queue(mod):
        rng = np.random.default_rng(0)
        a, b = (rng.integers(0, 256, 300).astype(np.uint64)
                for _ in range(2))
        return [mod.BbopInstr("addition", (a, b), 8),
                mod.BbopInstr("multiplication", (mod.Ref(0), b), 8),
                mod.BbopInstr("greater", (a, b), 8)]

    clean = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=4,
                           device="cpu").dispatch(queue(pt_bank))
    ch = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=4, device="cpu",
                        fault=FaultModel(p_flip=1e-4, spare_lanes=1, seed=9))
    _assert_same(ch.dispatch(queue(pt_bank)), clean)
    assert ch.stats.faults.injected > 0


def _injected_single_run(mod, make, p, seed, exc):
    eng = make(p, seed)
    lanes = np.arange(512, dtype=np.uint64) % np.uint64(256)
    try:
        eng.dispatch([mod.BbopInstr("multiplication", (lanes, lanes), 8)])
    except exc:
        pass
    return eng.stats.faults.injected


def test_channel_flips_agree_with_reference_in_distribution():
    def port(p, seed):
        return SimdramChannel(n_chips=2, n_banks=1, n_subarrays=1,
                              device="cpu",
                              fault=FaultModel(p_flip=p, spare_lanes=1,
                                               seed=seed, max_retries=0,
                                               max_redispatches=0))

    def ref(p, seed):
        return ref_channel.SimdramChannel(
            n_chips=2, n_banks=1, n_subarrays=1, use_shard_map=False,
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


def test_dead_units_blacklisted_and_remapped_like_reference():
    model = dict(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1, seed=11)
    clean = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                           device="cpu").dispatch(_small_queue(pt_bank))
    port = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device="cpu",
                          fault=FaultModel(**model))
    ref = ref_channel.SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                                     use_shard_map=False,
                                     fault=ref_fault.FaultModel(**model))
    assert any(b._fault_rt.dead.any() for c in port.chips for b in c.banks)
    got = port.dispatch(_small_queue(pt_bank))
    _assert_same(got, clean)
    _assert_same(got, ref.dispatch(_small_queue(ref_bank)))
    fs, rfs = port.stats.faults, ref.stats.faults
    assert fs.redispatches == rfs.redispatches
    assert fs.remapped == rfs.remapped
    assert _blacklists(port) == _blacklists(ref)


def test_channel_exhaustion_and_blacklist_coordinates():
    ch = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device="cpu",
                        fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                         spare_lanes=1, seed=1,
                                         max_redispatches=1))
    with pytest.raises(FaultExhaustedError) as info:
        ch.dispatch(_small_queue(pt_bank))
    assert info.value.tier == "channel"
    assert info.value.blacklist
    assert all(len(u) == 3 for u in info.value.blacklist)
    fresh = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                           device="cpu", fault=FaultModel(p_flip=0.0))
    assert fresh._blacklist_units([(1, 0, 1), (0, 1, 0), (1, 0, 1)]) == 2
    assert _blacklists(fresh) == [[set(), {0}], [{1}, set()]]
