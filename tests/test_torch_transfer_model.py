"""The DMA transfer/replay overlap model on the port, against the JAX
package, on the CPU.

Mirrors ``tests/test_transfer_model.py`` property by property through
the port's real ``SimdramChannel`` dispatch path, and holds every
dispatch's transfer fields ``==`` the reference's on the same queue.
Then reproduces the ``overlap`` block of ``BENCH_channel.json`` exactly
with ``benchmarks/channel_scaling.py``'s ``overlap_gates`` smoke
arguments (1 and 2 chips × 2 banks × 2 subarrays, 64 lanes, four
repeats of six 8-bit ops).
"""

import json
import math
from dataclasses import replace
from pathlib import Path

import numpy as np

from _hypothesis_compat import given, settings, st
from repro.core import bank as ref_bank
from repro.core import channel as ref_channel
from repro.core import timing as ref_timing
from repro_torch.core import bank as pt_bank
from repro_torch.core.channel import SimdramChannel
from repro_torch.core.ops_library import get_op
from repro_torch.core.timing import (DDR4, burst_rounded_bytes,
                                     d2h_transfer_s, h2d_transfer_s)

OPS = ("addition", "subtraction", "multiplication", "min", "max",
       "greater", "relu", "xor_red")
TRANSFER = ("transfer_bytes", "transfer_h2d_s", "transfer_d2h_s",
            "transfer_s", "transfer_overlapped_s", "exposed_transfer_s",
            "transfer_bound", "crossover_chips", "latency_s",
            "total_latency_s", "super_rounds")
ROOT = Path(__file__).resolve().parents[1]


def _rand_queue(mod, seed, n_bits=8, max_len=10):
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(int(rng.integers(2, max_len + 1))):
        if i > 0 and rng.integers(0, 4) == 0:
            queue.append(mod.BbopInstr("relu", (mod.Ref(i - 1),),
                                       queue[-1].n_bits))
            continue
        op = OPS[int(rng.integers(0, len(OPS)))]
        spec = get_op(op, n_bits)
        lanes = int(rng.integers(1, 70))
        ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                    for w in spec.operand_bits)
        kw = {}
        if rng.integers(0, 4) == 0:
            kw["keep_vertical"] = True
        queue.append(mod.BbopInstr(op, ops, n_bits, **kw))
    return queue


def _ref_cfg(cfg):
    """The reference's DramConfig with the port's field values."""
    return ref_timing.DramConfig(**{f: getattr(cfg, f)
                                    for f in cfg.__dataclass_fields__})


def _dispatch(seed, cfg, n_bits=8, max_len=10, n_chips=2, n_banks=2,
              n_subarrays=2):
    """The port's channel stats and results for one random queue; its
    transfer fields must equal the reference's on the same queue."""
    geo = dict(n_chips=n_chips, n_banks=n_banks, n_subarrays=n_subarrays)
    eng = SimdramChannel(cfg=cfg, device="cpu", **geo)
    results = eng.dispatch(_rand_queue(pt_bank, seed, n_bits, max_len))
    ref = ref_channel.SimdramChannel(cfg=_ref_cfg(cfg), use_shard_map=False,
                                     **geo)
    ref.dispatch(_rand_queue(ref_bank, seed, n_bits, max_len))
    got, want = eng.stats.as_dict(), ref.stats.as_dict()
    assert {k: got[k] for k in TRANSFER} == {k: want[k] for k in TRANSFER}
    return eng.stats, results


def _flat(results):
    return [x for r in results for x in pt_bank.flatten_result(r)]


# --- 1. overlap never exceeds serial --------------------------------------

@given(st.integers(0, 10_000), st.integers(4, 8), st.integers(1, 3),
       st.integers(1, 2))
@settings(max_examples=8, deadline=None)
def test_overlap_total_never_exceeds_serial(seed, n_bits, n_chips, n_banks):
    st_, _ = _dispatch(seed, DDR4, n_bits=n_bits, n_chips=n_chips,
                       n_banks=n_banks)
    assert 0.0 <= st_.transfer_overlapped_s <= st_.transfer_s
    assert st_.exposed_transfer_s == (st_.transfer_s
                                      - st_.transfer_overlapped_s)
    assert st_.exposed_transfer_s <= st_.transfer_s
    assert st_.transfer_s == st_.transfer_h2d_s + st_.transfer_d2h_s


# --- 2. disabled overlap is bit-exact with the serial charge --------------

@given(st.integers(0, 10_000), st.integers(4, 8))
@settings(max_examples=6, deadline=None)
def test_overlap_disabled_equals_serial_bitexact(seed, n_bits):
    on, r_on = _dispatch(seed, replace(DDR4, transfer_overlap=True),
                         n_bits=n_bits)
    off, r_off = _dispatch(seed, replace(DDR4, transfer_overlap=False),
                           n_bits=n_bits)
    assert off.transfer_overlapped_s == 0.0
    assert off.exposed_transfer_s == off.transfer_s
    assert off.transfer_h2d_s == on.transfer_h2d_s
    assert off.transfer_d2h_s == on.transfer_d2h_s
    assert off.transfer_bytes == on.transfer_bytes
    assert off.latency_s == on.latency_s
    assert off.super_rounds == on.super_rounds
    assert on.total_latency_s <= off.total_latency_s
    for x, y in zip(_flat(r_on), _flat(r_off)):
        np.testing.assert_array_equal(x, y)


# --- 3. monotone in either direction's bandwidth knob ---------------------

@given(st.integers(0, 10_000), st.sampled_from(["h2d_bw_gbs", "d2h_bw_gbs"]),
       st.sampled_from([2.0, 4.0, 19.2]))
@settings(max_examples=6, deadline=None)
def test_monotone_in_bandwidth_knob(seed, knob, slow_bw):
    fast = _dispatch(seed, replace(DDR4, **{knob: 2.0 * slow_bw}))[0]
    slow = _dispatch(seed, replace(DDR4, **{knob: slow_bw}))[0]
    direction = "transfer_h2d_s" if knob == "h2d_bw_gbs" else "transfer_d2h_s"
    assert getattr(slow, direction) >= getattr(fast, direction)
    assert slow.transfer_s >= fast.transfer_s
    assert slow.exposed_transfer_s >= fast.exposed_transfer_s
    assert slow.total_latency_s >= fast.total_latency_s
    assert slow.latency_s == fast.latency_s


# --- 4. burst rounding never undercharges ---------------------------------

@given(st.integers(0, 1 << 20), st.sampled_from([1, 8, 32, 64, 256]))
@settings(max_examples=50, deadline=None)
def test_burst_rounding_never_undercharges(n_bytes, burst):
    cfg = replace(DDR4, link_burst_bytes=burst)
    rounded = burst_rounded_bytes(n_bytes, cfg)
    assert rounded == ref_timing.burst_rounded_bytes(n_bytes, _ref_cfg(cfg))
    assert rounded >= n_bytes
    assert rounded % burst == 0
    assert rounded - n_bytes < burst
    floor = n_bytes / (cfg.channel_bw_gbs * 1e9)
    assert h2d_transfer_s(n_bytes, cfg) >= floor
    assert d2h_transfer_s(n_bytes, cfg) >= floor
    assert h2d_transfer_s(n_bytes, cfg) == ref_timing.h2d_transfer_s(
        n_bytes, _ref_cfg(cfg))


def test_burst_rounding_edge_cases():
    assert burst_rounded_bytes(0) == 0
    assert burst_rounded_bytes(-5) == 0
    assert burst_rounded_bytes(1) == DDR4.link_burst_bytes
    assert burst_rounded_bytes(64) == 64
    assert burst_rounded_bytes(65) == 128
    assert h2d_transfer_s(0) == 0.0 and d2h_transfer_s(0) == 0.0
    asym = replace(DDR4, h2d_bw_gbs=9.6, d2h_bw_gbs=4.8)
    assert h2d_transfer_s(64, asym) == 64 / (9.6 * 1e9)
    assert d2h_transfer_s(64, asym) == 64 / (4.8 * 1e9)
    assert burst_rounded_bytes(7, replace(DDR4, link_burst_bytes=0)) == 7


# --- 5. crossover moves outward under overlap -----------------------------

@given(st.integers(0, 10_000), st.integers(2, 3))
@settings(max_examples=6, deadline=None)
def test_crossover_moves_outward_under_overlap(seed, n_chips):
    on = _dispatch(seed, replace(DDR4, transfer_overlap=True),
                   max_len=12, n_chips=n_chips)[0]
    off = _dispatch(seed, replace(DDR4, transfer_overlap=False),
                    max_len=12, n_chips=n_chips)[0]
    assert float(on.chip_busy_s.sum()) == float(off.chip_busy_s.sum())
    if math.isinf(off.crossover_chips):
        assert math.isinf(on.crossover_chips)
    else:
        assert on.crossover_chips >= off.crossover_chips


# --- BENCH_channel.json's overlap block -------------------------------------

def _overlap_queue(lanes=64, repeats=4):
    """benchmarks/channel_scaling.py:overlap_gates' queue, on the port."""
    rng = np.random.default_rng(7)
    queue = []
    for op, n_bits in [("addition", 8), ("multiplication", 8),
                       ("greater", 8), ("subtraction", 8),
                       ("min", 8), ("max", 8)] * repeats:
        spec = get_op(op, n_bits)
        ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                    for w in spec.operand_bits)
        queue.append(pt_bank.BbopInstr(op, ops, n_bits))
    return queue


def test_overlap_block_of_bench_channel_reproduced():
    """The committed smoke run's overlap block, field for field, from
    the gate's smoke arguments (2 chips × 2 banks × 2 subarrays)."""
    want = json.loads((ROOT / "BENCH_channel.json").read_text())["overlap"]
    geo = dict(n_chips=2, n_banks=2, n_subarrays=2, device="cpu")
    on = SimdramChannel(cfg=DDR4, **geo)
    r_on = on.dispatch(_overlap_queue())
    off = SimdramChannel(cfg=replace(DDR4, transfer_overlap=False), **geo)
    r_off = off.dispatch(_overlap_queue())
    for x, y in zip(_flat(r_on), _flat(r_off)):
        np.testing.assert_array_equal(x, y)
    son, soff = on.stats, off.stats
    got = {
        "super_rounds": son.super_rounds,
        "bit_exact": True,
        "serial_transfer_s": soff.transfer_s,
        "transfer_overlapped_s": son.transfer_overlapped_s,
        "exposed_transfer_s": son.exposed_transfer_s,
        "hidden_fraction": son.transfer_overlapped_s / soff.transfer_s,
        "total_latency_s": son.total_latency_s,
        "serial_total_latency_s": soff.total_latency_s,
        "crossover_chips": son.crossover_chips,
        "serial_crossover_chips": soff.crossover_chips,
    }
    assert got == want
    assert got["super_rounds"] == 3
    assert got["hidden_fraction"] == 0.7123287671232875
    assert got["crossover_chips"] == 2786.571428571427
    assert got["serial_crossover_chips"] == 801.6164383561644
