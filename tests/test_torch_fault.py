"""The fault layer and K6 (fault-injected replay): the port against the
JAX package on the CPU.

Everything the reference draws with numpy (the reliability Monte-Carlo,
dead units, stuck-at masks, per-attempt keys) must equal it (``==``).
Flip bits cannot: the reference draws them with ``jax.random`` and the
port with Philox.  So K6's plain version is held bit for bit against the
reference at ``p_flip`` 0 and 1, where the reference is deterministic,
and a stuck-only dispatch against the reference's results and every
``FaultStats`` field; the rest mirrors the bank-tier cases of
``tests/test_fault.py`` on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import area as ref_area
from repro.core import bank as ref_bank
from repro.core import control_unit as ref_cu
from repro.core import fault as ref_fault
from repro.core import reliability as ref_rel
from repro_torch.core import area
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core import fault, reliability
from repro_torch.core.bank import Bank, BbopInstr, Ref, flatten_result
from repro_torch.core.fault import (FaultExhaustedError, FaultModel,
                                    FaultStats, dereplicate_results,
                                    replicate_queue)
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.ops_library import get_op

U = np.uint64


def _queue(lanes=100, seed=0, mod=pt_bank):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, lanes).astype(U)
    b = rng.integers(0, 256, lanes).astype(U)
    return [
        mod.BbopInstr("addition", (a, b), 8),
        mod.BbopInstr("multiplication", (mod.Ref(0), b), 8),
        mod.BbopInstr("greater", (a, b), 8),
    ]


def _small_queue(seed=3, lanes=64, mod=pt_bank):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, lanes).astype(U)
    b = rng.integers(0, 256, lanes).astype(U)
    return [mod.BbopInstr("addition", (a, b), 8),
            mod.BbopInstr("min", (a, b), 8)]


def _flat(results):
    return [np.asarray(x) for r in results for x in flatten_result(r)]


def _exact(xs, ys):
    return all(np.array_equal(np.asarray(p), np.asarray(q))
               for x, y in zip(xs, ys)
               for p, q in zip(flatten_result(x), flatten_result(y)))


def _bank(**kw):
    return Bank(device="cpu", **kw)


@pytest.fixture(scope="module")
def clean():
    return _bank(n_subarrays=4).dispatch(_queue())


# ---------------------------------------------------------------------------
# Philox and K6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(int(x) for x in cu.philox4x32(counter, key)) == want


def _random_wave(seed, ops=(("addition", 8), ("multiplication", 8),
                            ("greater", 16)), n_words=4):
    rng = np.random.default_rng(seed)
    tabs = [ref_bank.cached_table(op, w)[2] for op, w in ops]
    width = max(t.shape[0] for t in tabs)
    tables = np.stack([ref_cu.pad_command_table(t, width) for t in tabs])
    n = len(ops)
    states = rng.integers(0, 2**32, (n, 64, n_words), dtype=np.uint32)
    s0 = (rng.integers(0, 2**32, (n, n_words), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, n_words), dtype=np.uint32))
    s1 = (rng.integers(0, 2**32, (n, n_words), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, n_words), dtype=np.uint32) & ~s0)
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    return states, tables, keys, s0, s1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("p_flip", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_faulty_replay_plain_matches_reference(p_flip, seed):
    states, tables, keys, s0, s1 = _random_wave(seed)
    dead = np.zeros(len(states), bool)
    want, want_n = ref_cu.faulty_bank_replay(
        jnp.asarray(states), jnp.asarray(tables), jnp.asarray(keys),
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(dead),
        np.float32(p_flip))
    got, got_n = cu.faulty_bank_replay(
        _t(states), torch.from_numpy(tables), _t(keys), _t(s0), _t(s1),
        torch.from_numpy(dead), p_flip)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(),
                                  np.asarray(want_n).astype(np.int64))


def test_flip_masks_follow_the_counter_layout():
    """Bit 4 call + lane of a word's mask is set when output ``lane`` of
    Philox call (word, command, 0, call) is below the threshold."""
    keys = torch.tensor([[5, -7]], dtype=torch.int32)
    thr = cu.flip_threshold(0.3)
    masks = cu.flip_masks_plain(keys, torch.tensor([2, 9]), 3, thr)
    for j, c in enumerate((2, 9)):
        for w in range(3):
            want = 0
            for call in range(cu.FLIP_CALLS):
                outs = cu.philox4x32((w, c, cu.STREAM_FLIP, call),
                                     (5, 2**32 - 7))
                for lane, u in enumerate(outs):
                    want |= int(int(u) < thr) << (4 * call + lane)
            assert int(masks[0, j, w]) & 0xFFFFFFFF == want


def test_flip_rate_of_plain_masks_within_binomial_bounds():
    p = 0.01
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    masks = cu.flip_masks_plain(keys, torch.arange(200), 16,
                                cu.flip_threshold(p))
    n = masks.numel() * 32
    flips = int(cu.popcount_u32(masks).sum())
    sd = np.sqrt(n * p * (1 - p))
    assert abs(flips - n * p) < 6 * sd, (flips, n * p, sd)


def test_dead_unit_garbage_has_about_half_its_bits_set():
    """Garbage XORed over a dead unit is uniform: its popcount over n
    bits is Binomial(n, 1/2), held within 6 standard deviations."""
    states, tables, keys, s0, s1 = _random_wave(2, n_words=8)
    dead = np.array([True, False, True])
    args = (_t(states), torch.from_numpy(tables), _t(keys), _t(s0), _t(s1))
    alive, _ = cu.faulty_bank_replay(*args, torch.zeros(3, dtype=bool), 0.0)
    hit, _ = cu.faulty_bank_replay(*args, torch.from_numpy(dead), 0.0)
    diff = alive ^ hit
    assert int(cu.popcount_u32(diff[1]).sum()) == 0
    for u in (0, 2):
        n = diff[u].numel() * 32
        ones = int(cu.popcount_u32(diff[u]).sum())
        assert abs(ones - n / 2) < 6 * np.sqrt(n / 4), (ones, n)


def test_faulty_replay_validates_inputs():
    states, tables, keys, s0, s1 = _random_wave(3)
    args = [_t(states), torch.from_numpy(tables), _t(keys), _t(s0), _t(s1),
            torch.zeros(3, dtype=bool)]
    with pytest.raises(ValueError, match="p_flip"):
        cu.faulty_bank_replay(*args, 1.5)
    bad = list(args)
    bad[2] = _t(keys[:2])
    with pytest.raises(ValueError, match="keys"):
        cu.faulty_bank_replay(*bad, 0.0)


# ---------------------------------------------------------------------------
# numpy draws: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma,node", [(0.05, "22nm"), (0.15, "17nm"),
                                        (0.18, "17nm"), (0.25, "7nm")])
def test_tra_failure_breakdown_equals_reference(sigma, node):
    got = reliability.tra_failure_breakdown(
        sigma, reliability.TECH_NODES[node], 20_000)
    want = ref_rel.tra_failure_breakdown(
        sigma, ref_rel.TECH_NODES[node], 20_000)
    assert got == want


@pytest.mark.parametrize("sigma,node,trials", [(0.15, "17nm", 50_000),
                                               (0.2, "10nm", 20_000)])
def test_derived_flip_p_equals_reference(sigma, node, trials):
    assert fault._derived_flip_p(sigma, node, trials) == \
        ref_fault._derived_flip_p(sigma, node, trials)


@pytest.mark.parametrize("kw,seed_path", [
    ({"dead_unit_rate": 0.4, "seed": 11}, ()),
    ({"stuck_lane_rate": 0.02, "seed": 13}, ()),
    ({"stuck_lane_rate": 0.05, "stuck_cluster": 2, "dead_unit_rate": 0.2,
      "seed": 3}, (1, 2)),
])
def test_fault_runtime_draws_equal_reference(kw, seed_path):
    got = fault.FaultRuntime(FaultModel(**kw), seed_path, 4)
    want = ref_fault.FaultRuntime(ref_fault.FaultModel(**kw), seed_path, 4)
    np.testing.assert_array_equal(got.dead, want.dead)
    for g, w in zip(got.stuck_masks(64), want.stuck_masks(64)):
        np.testing.assert_array_equal(g, w)
    for _ in range(3):
        np.testing.assert_array_equal(got.draw_keys(), want.draw_keys())


@pytest.mark.parametrize("kw", [
    {"stuck_lane_rate": 0.02, "spare_lanes": 2, "seed": 13},
    {"stuck_lane_rate": 0.05, "spare_lanes": 1, "seed": 3},
    {"stuck_lane_rate": 0.05, "spare_lanes": 0, "seed": 7},
])
def test_stuck_only_dispatch_equals_reference(kw):
    """With ``p_flip = 0`` and no dead unit nothing is drawn with
    ``jax.random``, so results, ``FaultStats`` and ``BankStats`` are
    ``==`` the reference's — redispatches and blacklists included."""
    model = dict(p_flip=0.0, **kw)
    ref = ref_bank.Bank(n_subarrays=4, fault=ref_fault.FaultModel(**model))
    port = _bank(n_subarrays=4, fault=FaultModel(**model))
    outs = []
    for b, mod in ((ref, ref_bank), (port, pt_bank)):
        try:
            outs.append(("ok", b.dispatch(_small_queue(mod=mod))))
        except (ref_fault.FaultExhaustedError, FaultExhaustedError) as e:
            outs.append(("exhausted", e.context()))
    assert outs[0][0] == outs[1][0]
    if outs[0][0] == "ok":
        for g, w in zip(_flat(outs[1][1]), _flat(outs[0][1])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    else:
        assert outs[0][1] == outs[1][1]
    assert port.stats.faults.as_dict() == ref.stats.faults.as_dict()
    ps, rs = port.stats.as_dict(), ref.stats.as_dict()
    for k in ("wall_s", "pack_wall_s"):
        ps.pop(k), rs.pop(k)
    assert ps == rs
    assert port._blacklist == ref._blacklist


def test_vote_accepts_replicas_stuck_alike_as_the_reference_does():
    """Two of three replicas on columns stuck at one polarity outvote the
    third: the dispatch returns a stuck constant for that lane, without a
    retry.  The reference does the same on the same lanes."""
    model = dict(p_flip=0.0, stuck_lane_rate=0.05, spare_lanes=2, seed=1)
    ref = ref_bank.Bank(n_subarrays=4, fault=ref_fault.FaultModel(**model))
    port = _bank(n_subarrays=4, fault=FaultModel(**model))
    q = _small_queue()
    got = _flat(port.dispatch(q))
    want = _flat(ref.dispatch(_small_queue(mod=ref_bank)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    oracle = [np.asarray(o).astype(np.int64) & 0xFF for ins in q
              for o in get_op(ins.op, ins.n_bits).oracle(*ins.operands)]
    wrong = [(g.astype(np.int64) & 0xFF)[g.astype(np.int64) & 0xFF != e]
             for g, e in zip(got, oracle)]
    assert sum(len(x) for x in wrong) == 2
    assert all(np.isin(x, (0, 0xFF)).all() for x in wrong)
    assert port.stats.faults.retries == 0


def test_area_model_equals_reference():
    assert area.DEFAULT_AREA.report() == ref_area.DEFAULT_AREA.report()
    for kw in ({"rows_per_subarray": 512}, {"compute_rows": 8,
                                            "decoder_overhead_frac": 0.01}):
        assert area.AreaModel(**kw).report() == \
            ref_area.AreaModel(**kw).report()
    assert dataclasses.asdict(area.DEFAULT_AREA) == \
        dataclasses.asdict(ref_area.DEFAULT_AREA)


# ---------------------------------------------------------------------------
# mirrors of tests/test_fault.py (bank tier)
# ---------------------------------------------------------------------------

def test_model_validation():
    with pytest.raises(ValueError):
        FaultModel(p_flip=1.5)
    with pytest.raises(ValueError):
        FaultModel(spare_lanes=-1)
    with pytest.raises(ValueError):
        FaultModel(max_retries=-1)


def test_flip_probability_derives_from_reliability():
    m = FaultModel(sigma=0.15, tech_node="17nm", p_trials=50_000)
    assert m.flip_probability() == pytest.approx(
        reliability.tra_failure_breakdown(0.15, n_trials=50_000)["overall"])
    assert FaultModel(p_flip=1e-3).flip_probability() == 1e-3


def test_replicate_dereplicate_roundtrip():
    q = _queue(lanes=40)
    rep = replicate_queue(q, 3)
    for ins, orig in zip(rep, q):
        for o, oo in zip(ins.operands, orig.operands):
            if isinstance(oo, Ref):
                assert o is oo
            else:
                arr = np.asarray(o)
                assert arr.shape[-1] == 3 * np.asarray(oo).shape[-1]
                assert np.array_equal(arr.reshape(3, -1)[1],
                                      np.asarray(oo))
    back = dereplicate_results(
        [np.tile(np.asarray(o), 3) for ins in q
         for o in [ins.operands[1]]], 3)
    for got, ins in zip(back, q):
        assert np.array_equal(got, np.asarray(ins.operands[1]))


def _injected_single_run(p, seed, lanes=512):
    """stats.injected for exactly ONE replay (no retries)."""
    model = FaultModel(p_flip=p, spare_lanes=1, seed=seed,
                       max_retries=0, max_redispatches=0)
    bank = _bank(n_subarrays=2, fault=model)
    try:
        bank.dispatch([BbopInstr("multiplication",
                                 (np.arange(lanes, dtype=U) % U(256),
                                  np.arange(lanes, dtype=U) % U(256)),
                                 8)])
    except FaultExhaustedError:
        pass                     # single-attempt runs may not converge
    return bank.stats.faults.injected


def test_flip_rate_within_confidence_bounds():
    n_draws = 2 * _injected_single_run(0.5, seed=0)
    assert n_draws > 10_000
    p = 1e-3
    pooled, runs = 0, 8
    for seed in range(runs):
        pooled += _injected_single_run(p, seed=seed)
    mean = runs * n_draws * p
    sd = np.sqrt(runs * n_draws * p * (1 - p))
    assert abs(pooled - mean) < 6 * sd + 10, (pooled, mean, sd)


def test_bank_flips_detected_and_bit_exact(clean):
    bank = _bank(n_subarrays=4,
                 fault=FaultModel(p_flip=1e-4, spare_lanes=1, seed=1))
    out = bank.dispatch(_queue())
    assert _exact(out, clean)
    fs = bank.stats.faults
    assert fs.injected > 0 and fs.detected > 0 and fs.retries > 0
    assert fs.overhead_s > 0
    assert bank.stats.total_latency_s > bank.stats.latency_s


def test_bank_checksum_fallback_no_spares(clean):
    bank = _bank(n_subarrays=4,
                 fault=FaultModel(p_flip=1e-4, spare_lanes=0, seed=2))
    out = bank.dispatch(_queue())
    assert _exact(out, clean)
    assert bank.stats.faults.detected > 0


def test_dead_subarrays_blacklisted_and_remapped():
    ref = _bank(n_subarrays=4).dispatch(_small_queue())
    bank = _bank(n_subarrays=4,
                 fault=FaultModel(p_flip=0.0, dead_unit_rate=0.4,
                                  spare_lanes=1, seed=11))
    assert bank._fault_rt.dead.any()
    out = bank.dispatch(_small_queue())
    assert _exact(out, ref)
    fs = bank.stats.faults
    assert fs.redispatches > 0 and fs.remapped > 0
    assert bank._blacklist
    fs2 = FaultStats()
    bank.stats.faults = fs2
    assert _exact(bank.dispatch(_small_queue()), ref)
    assert fs2.redispatches == 0


def test_stuck_column_clusters_survive_strided_replicas():
    ref = _bank(n_subarrays=4).dispatch(_small_queue())
    bank = _bank(n_subarrays=4,
                 fault=FaultModel(p_flip=0.0, stuck_lane_rate=0.02,
                                  spare_lanes=2, seed=13))
    out = bank.dispatch(_small_queue())
    assert _exact(out, ref)
    fs = bank.stats.faults
    assert fs.detected > 0 and fs.corrected > 0


def test_exhaustion_raises():
    bank = _bank(n_subarrays=2,
                 fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                  spare_lanes=1, seed=1,
                                  max_redispatches=1))
    with pytest.raises(FaultExhaustedError) as info:
        bank.dispatch(_small_queue())
    assert info.value.tier == "bank"
    assert info.value.context()["cause"] in ("no_capacity",
                                             "redispatch_budget")


def test_disabled_model_is_free():
    q = _small_queue()
    plain = _bank(n_subarrays=2)
    r_plain = plain.dispatch(_small_queue())
    k0 = cu.kernel_counts()
    off = _bank(n_subarrays=2, fault=FaultModel(enabled=False))
    assert off.fault is None and off._fault_rt is None
    r_off = off.dispatch(q)
    assert cu.kernel_counts() == k0      # nothing built, no K6 launch
    assert _exact(r_off, r_plain)
    assert off.stats.faults.overhead_s == 0.0
    assert not off.stats.faults.any
    assert off.stats.latency_s == plain.stats.latency_s
    assert off.stats.total_latency_s == plain.stats.total_latency_s
    on, ref = off.stats.as_dict(), plain.stats.as_dict()
    for k in ("wall_s", "pack_wall_s"):
        on.pop(k), ref.pop(k)
    assert on == ref


def test_fault_requires_interp_fused():
    with pytest.raises(ValueError):
        _bank(engine="bitplane", fault=FaultModel())
    with pytest.raises(ValueError):
        _bank(fuse=False, fault=FaultModel())


@given(st.integers(0, 10_000), st.sampled_from([1e-4, 3e-4]),
       st.integers(1, 2))
@settings(max_examples=10, deadline=None)
def test_retry_converges_or_raises(seed, p, spares):
    q = _small_queue(seed=4, lanes=32)
    ref = _bank(n_subarrays=2).dispatch(_small_queue(seed=4, lanes=32))
    bank = _bank(n_subarrays=2,
                 fault=FaultModel(p_flip=p, spare_lanes=spares, seed=seed))
    try:
        out = bank.dispatch(q)
    except FaultExhaustedError:
        return
    assert _exact(out, ref)


def test_device_passes_the_model_to_the_bank():
    """``SimdramDevice(fault=...)`` no longer raises: the bank engine
    injects, the other backends ignore the model (as in the
    reference)."""
    model = FaultModel(p_flip=1e-4, spare_lanes=1, seed=1)
    dev = SimdramDevice(backend="bank", device="cpu", fault=model)
    assert dev.bank().fault is model
    res = dev.dispatch(_queue())
    clean = SimdramDevice(backend="bank", device="cpu").dispatch(_queue())
    assert _exact(res, clean)
    assert dev.bank().stats.faults.injected > 0
    x = np.arange(64, dtype=U) % U(256)
    got = SimdramDevice(backend="bitplane", device="cpu",
                        fault=model).bbop("addition", x, x, n_bits=8)
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64) & 0xFF,
                                  (2 * x.astype(np.int64)) & 0xFF)
