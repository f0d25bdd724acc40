"""The port's bank engine against the JAX package's, on the CPU.

Mirrors ``tests/test_bank_engine.py`` test for test, at its widths (8
bits, 96 lanes; 1, 4 and 16 subarrays): the port's ``Bank`` on the CPU
(the plain replay K5 stands for on the card) against the reference's
op oracles, its timing and energy models and its command tables.  Where
the reference counts compiled XLA executables
(``test_shared_executable_across_ops``,
``test_partial_batch_reuses_full_width_executable``) the port counts
kernel builds and launches (``kernel_counts()``) and command-table cache
hits and misses (``cached_table``'s and ``TABLE_CACHE.stats()``): a
repeated replay builds nothing and rebuilds no table.  The round-robin
order case is ``test_torch_fused_dispatch.py``'s
``test_round_robin_wraparound_large_queue`` at the reference test's
queue, run here through the same function.  The last case reproduces
the modeled fields of ``benchmarks/bank_scaling.py --smoke`` (its
``table_hetero_dispatch`` called at the smoke configuration) with the
port's ``Bank``, ``==``.
"""

import contextlib
import io
import zlib

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from test_torch_examples_core import one_torch_thread  # noqa: F401
from repro.core import bank as ref_bank
from repro.core import timing as ref_timing
from repro.core.energy import uprogram_energy_nj as ref_energy_nj
from repro.core.isa import compile_op as ref_compile_op
from repro.core.ops_library import get_op as ref_get_op
from repro_torch.core.bank import (Bank, BbopInstr, Ref, cached_table,
                                   random_operand_sets)
from repro_torch.core.control_unit import (TABLE_CACHE, batched_interpreter,
                                           kernel_counts, pad_command_table,
                                           table_bucket)
from repro_torch.core.isa import SimdramDevice, compile_op
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.timing import (DDR4, DramConfig, bank_latency_s,
                                     bank_throughput_gops,
                                     uprogram_latency_s)

CPU = "cpu"
N_BITS = 8
LANES = 96
MEASURED = ("wall_s", "pack_wall_s")


def _operand_sets(spec, n_sets, lanes=LANES, seed=0):
    sets = random_operand_sets(spec, n_sets, lanes, seed)
    want = ref_bank.random_operand_sets(ref_get_op(spec.name, spec.n_bits),
                                        n_sets, lanes, seed)
    assert all(np.array_equal(a, b) for s, t in zip(sets, want)
               for a, b in zip(s, t))
    return sets


def _check_against_oracle(spec, results, sets):
    """Lane for lane the reference's oracle of the same op."""
    ref = ref_get_op(spec.name, spec.n_bits)
    for got, operands in zip(results, sets):
        want = ref.oracle(*operands)
        got = got if isinstance(got, tuple) else (got,)
        for gi, (g, e) in enumerate(zip(got, want)):
            mask = (1 << spec.out_bits[gi]) - 1
            np.testing.assert_array_equal(
                np.asarray(g).astype(np.int64) & mask,
                e.astype(np.int64) & mask)


@pytest.mark.parametrize("n_subarrays", [1, 4, 16])
@pytest.mark.parametrize("style", ["mig", "aig"])
@pytest.mark.parametrize("op", ALL_OPS)
def test_engine_matches_oracle_all_ops(op, style, n_subarrays):
    """Every op × style × bank width: engine == the reference's oracle on
    all lanes, and its command counts and modeled latency and energy ==
    the reference's models of the reference's μProgram."""
    bank = Bank(n_subarrays=n_subarrays, style=style, device=CPU)
    spec = get_op(op, N_BITS)
    sets = _operand_sets(spec, n_subarrays,
                         seed=zlib.crc32(f"{op}/{style}".encode()))
    _check_against_oracle(
        spec, bank.execute_batch(op, N_BITS, sets), sets)
    _, up = ref_compile_op(op, N_BITS, style)
    st_ = bank.stats
    assert (st_.aap, st_.ap) == (up.n_aap * n_subarrays,
                                 up.n_ap * n_subarrays)
    assert st_.latency_s == ref_timing.bank_latency_s(up, n_subarrays,
                                                      n_subarrays)
    assert st_.energy_nj == pytest.approx(ref_energy_nj(up) * n_subarrays,
                                          rel=1e-12)


@pytest.mark.parametrize("op", ["addition", "multiplication", "division",
                                "greater", "min", "max", "subtraction"])
def test_engine_matches_bitplane_fast_path(op):
    """interp engine == bit-plane fast path == the cuda engine's plain
    versions (the reference's pallas), lane-exact, and == the oracle."""
    spec = get_op(op, N_BITS)
    sets = _operand_sets(spec, 4, seed=7)
    outs = {}
    for engine in ("interp", "bitplane", "cuda"):
        bank = Bank(n_subarrays=4, engine=engine, device=CPU)
        outs[engine] = bank.execute_batch(op, N_BITS, sets)
    _check_against_oracle(spec, outs["interp"], sets)
    for engine in ("bitplane", "cuda"):
        for a, b in zip(outs["interp"], outs[engine]):
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            for gi, (x, y) in enumerate(zip(a, b)):
                mask = (1 << spec.out_bits[gi]) - 1
                np.testing.assert_array_equal(
                    np.asarray(x).astype(np.int64) & mask,
                    np.asarray(y).astype(np.int64) & mask, err_msg=engine)


SHARED_OPS = ("addition", "subtraction", "greater", "greater_equal",
              "equal", "min", "max")


def test_shared_executable_across_ops():
    """Ops whose bucketed (rows, cmds) shapes coincide replay through one
    kernel binary: replaying them all again builds no kernel and no
    table (``cached_table`` and ``TABLE_CACHE`` hit), and the bucketed
    shapes are the reference's, fewer than the ops."""
    bank = Bank(n_subarrays=4, device=CPU)
    shapes, ref_shapes = set(), set()
    for op in SHARED_OPS:
        _, uprog, table = cached_table(op, N_BITS)
        shapes.add((-(-uprog.n_rows_total // 16) * 16, table.shape[0]))
        _, rup, rtable = ref_bank.cached_table(op, N_BITS)
        ref_shapes.add((-(-rup.n_rows_total // 16) * 16, rtable.shape[0]))
        bank.execute_batch(op, N_BITS, _operand_sets(get_op(op, N_BITS), 4))
        bank.dispatch([BbopInstr(op, tuple(s), N_BITS)
                       for s in _operand_sets(get_op(op, N_BITS), 4)])
    k0, c0 = kernel_counts(), TABLE_CACHE.stats()
    t0 = cached_table.cache_info()
    for op in SHARED_OPS:
        spec = get_op(op, N_BITS)
        bank.execute_batch(op, N_BITS, _operand_sets(spec, 4, seed=9))
        bank.dispatch([BbopInstr(op, tuple(s), N_BITS)
                       for s in _operand_sets(spec, 4)])
    k1, c1 = kernel_counts(), TABLE_CACHE.stats()
    t1 = cached_table.cache_info()
    assert k1 == k0                        # no build, no launch on the CPU
    assert t1.misses == t0.misses and t1.hits > t0.hits
    assert c1["misses"] == c0["misses"] and c1["hits"] > c0["hits"]
    assert shapes == ref_shapes and len(shapes) < len(SHARED_OPS)


def test_partial_batch_reuses_full_width_executable():
    """A 2-set batch on a 4-subarray bank builds nothing new: the state is
    padded to the full bank width, one table lookup that hits."""
    bank = Bank(n_subarrays=4, device=CPU)
    spec = get_op("addition", N_BITS)
    sets4 = _operand_sets(spec, 4)
    bank.execute_batch("addition", N_BITS, sets4)
    k0, t0 = kernel_counts(), cached_table.cache_info()
    sets2 = _operand_sets(spec, 2)
    _check_against_oracle(
        spec, bank.execute_batch("addition", N_BITS, sets2), sets2)
    k1, t1 = kernel_counts(), cached_table.cache_info()
    assert k1 == k0 and t1.misses == t0.misses


@given(st.sampled_from(["addition", "subtraction", "min", "max", "greater"]),
       st.integers(2, 10), st.integers(1, 5), st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_engine_property_random_width_and_batch(op, n_bits, n_sets, seed):
    """Random widths/batch sizes/operands: engine == the reference's
    oracle (property)."""
    bank = Bank(n_subarrays=n_sets, device=CPU)
    spec = get_op(op, n_bits)
    rng = np.random.default_rng(seed)
    lanes = [int(rng.integers(1, 80)) for _ in range(n_sets)]
    sets = [
        [rng.integers(0, 1 << w, size=n).astype(np.uint64)
         for w in spec.operand_bits]
        for n in lanes
    ]
    _check_against_oracle(spec, bank.execute_batch(op, n_bits, sets), sets)
    assert bank.stats.elements == sum(lanes)


def test_bbop_splits_lanes_across_bank():
    """Bank.bbop splits one large instruction across subarrays and
    reassembles in lane order, in one replay, with the reference's
    modeled stats."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=1000)
    y = rng.integers(0, 256, size=1000)
    for n_sub in (1, 4, 16):
        bank = Bank(n_subarrays=n_sub, device=CPU)
        got = bank.bbop("addition", x, y, n_bits=8)
        want = ref_get_op("addition", 8).oracle(
            x.astype(np.uint64), y.astype(np.uint64))[0]
        np.testing.assert_array_equal(
            got.astype(np.int64) & 0xFF, want.astype(np.int64) & 0xFF)
        assert bank.stats.batches == 1    # one concurrent replay
        ref = ref_bank.Bank(n_subarrays=n_sub)
        ref.bbop("addition", x, y, n_bits=8)
        assert ({k: v for k, v in bank.stats.as_dict().items()
                 if k not in MEASURED}
                == {k: v for k, v in ref.stats.as_dict().items()
                    if k not in MEASURED})


def test_dispatch_round_robin_and_order():
    """The reference test's queue (11 instructions, seed 4, 64 lanes)
    through ``test_torch_fused_dispatch.py``'s round-robin case: oracle-
    exact, the reference's results and modeled stats, 11 bbops placed
    with no subarray more than two programs ahead."""
    from test_torch_fused_dispatch import round_robin_case
    bank = round_robin_case(11, seed=4, lanes=64)
    assert bank.stats.bbops == 11


def test_stats_match_timing_and_energy_models():
    bank = Bank(n_subarrays=4, device=CPU)
    spec = get_op("addition", N_BITS)
    _, uprog = compile_op("addition", N_BITS)
    _, ref_up = ref_compile_op("addition", N_BITS)
    sets = _operand_sets(spec, 4)
    bank.execute_batch("addition", N_BITS, sets)
    bank.execute_batch("addition", N_BITS, sets)
    st_ = bank.stats
    assert st_.latency_s == pytest.approx(bank_latency_s(uprog, 8, 4))
    assert st_.latency_s == pytest.approx(
        ref_timing.bank_latency_s(ref_up, 8, 4), rel=1e-12)
    assert st_.energy_nj == pytest.approx(ref_energy_nj(ref_up) * 8)
    assert st_.aap == ref_up.n_aap * 8 and st_.ap == ref_up.n_ap * 8


def test_stats_respect_column_capacity():
    """Lanes beyond cfg.columns_per_subarray serialize extra replays —
    stats cannot report throughput above the physical ceiling."""
    cfg = DramConfig(columns_per_subarray=64)
    bank = Bank(n_subarrays=2, cfg=cfg, device=CPU)
    _, uprog = compile_op("addition", N_BITS)
    spec = get_op("addition", N_BITS)
    sets = _operand_sets(spec, 2, lanes=200)    # 200 lanes on 64 columns
    _check_against_oracle(
        spec, bank.execute_batch("addition", N_BITS, sets), sets)
    st_ = bank.stats
    invs = -(-200 // 64)                         # 4 serialized replays
    assert st_.latency_s == pytest.approx(
        invs * uprogram_latency_s(uprog, cfg))
    assert st_.aap == uprog.n_aap * invs * 2
    ref = ref_bank.Bank(n_subarrays=2,
                        cfg=ref_timing.DramConfig(columns_per_subarray=64))
    ref.execute_batch("addition", N_BITS, sets)
    assert ({k: v for k, v in st_.as_dict().items() if k not in MEASURED}
            == {k: v for k, v in ref.stats.as_dict().items()
                if k not in MEASURED})


def test_bank_throughput_scales_linearly():
    _, up = compile_op("addition", 16)
    _, ref_up = ref_compile_op("addition", 16)
    for n in (1, 4, 16):
        assert bank_throughput_gops(up, DDR4, n_subarrays=n) == \
            ref_timing.bank_throughput_gops(ref_up, ref_timing.DDR4,
                                            n_subarrays=n)
    t1 = bank_throughput_gops(up, DDR4, n_subarrays=1)
    assert bank_throughput_gops(up, DDR4, n_subarrays=4) / t1 == \
        pytest.approx(4.0)
    assert bank_throughput_gops(up, DDR4, n_subarrays=16) / t1 == \
        pytest.approx(16.0)


def test_device_bank_backend():
    """SimdramDevice(backend="bank") routes bbops through the engine."""
    dev = SimdramDevice(cfg=DramConfig(n_banks=4), backend="bank",
                        device=CPU)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, 200)
    y = rng.integers(0, 256, 200)
    got = dev.bbop("addition", x, y, n_bits=8)
    want = ref_get_op("addition", 8).oracle(
        x.astype(np.uint64), y.astype(np.uint64))[0]
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.int64) & 0xFF, want.astype(np.int64) & 0xFF)
    assert dev.bank().n_subarrays == 4
    assert dev.totals()["calls"] == 1


def test_nop_padding_is_inert():
    """NOP rows appended by table bucketing leave the state untouched,
    and the padded table is the reference's byte for byte."""
    import torch
    _, uprog, table = cached_table("addition", N_BITS)
    raw_cmds = len(uprog.commands)
    assert table.shape[0] == table_bucket(raw_cmds)
    assert (table[raw_cmds:] == 0).all()
    assert table.tobytes() == ref_bank.cached_table("addition",
                                                    N_BITS)[2].tobytes()
    run = batched_interpreter(CPU)
    rng = np.random.default_rng(6)
    state = rng.integers(0, 2**32, size=(2, 32, 4), dtype=np.uint32)
    nops = np.zeros((8, table.shape[1]), np.int32)
    out = run(state, nops)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), state)


def test_table_bucket_monotone_bounded():
    from repro.core.control_unit import table_bucket as ref_table_bucket
    for n in (1, 16, 17, 64, 65, 1048):
        assert table_bucket(n) == ref_table_bucket(n)
    assert table_bucket(1) == 16
    assert table_bucket(16) == 16
    assert table_bucket(17) == 32
    assert table_bucket(64) == 64
    assert table_bucket(65) == 128
    assert table_bucket(1048) == 2048
    with pytest.raises(ValueError):
        pad_command_table(np.zeros((10, 13), np.int32), 8)


def _port_queue(queue):
    """A reference queue as the port's: the same operands, ``Ref``s and
    flags."""
    def operand(o):
        return Ref(o.producer, o.out) if isinstance(o, ref_bank.Ref) else o
    return [BbopInstr(i.op, tuple(operand(o) for o in i.operands), i.n_bits,
                      signed_out=i.signed_out, keep_vertical=i.keep_vertical)
            for i in queue]


def test_bank_scaling_smoke_modeled_fields():
    """``benchmarks/bank_scaling.py --smoke`` (2 subarrays, 64 lanes, 8
    instructions): its ``table_hetero_dispatch`` on the reference, and
    the same queues through the port's ``Bank`` (fused with each packing
    and grouped): every modeled field of its report ``==`` — replays,
    fused waves, modeled and replay latency, throughputs, transposition
    charges and skips, table-cache hits and misses per repeat dispatch,
    the compaction margin and the registry's non-measured gauges."""
    import benchmarks.bank_scaling as bs
    with contextlib.redirect_stdout(io.StringIO()):
        report = bs.table_hetero_dispatch(n_subarrays=2, lanes=64,
                                          n_instrs=8, out_json=None)
    scenarios = {"mix": lambda: bs._mix_queue(64, 8, (8, 16), 0),
                 "chain": lambda: bs._chain_queue(64, 0)}
    for name, mk in scenarios.items():
        want = report["scenarios"][name]
        got = {}
        for key, fuse, packing in (("fused", True, "reorder"),
                                   ("fused_ffd_packing", True, "ffd"),
                                   ("fused_greedy_packing", True, "greedy"),
                                   ("grouped", False, "reorder")):
            bank = Bank(n_subarrays=2, fuse=fuse, packing=packing,
                        device=CPU)
            bank.dispatch(_port_queue(mk()))
            bank.reset_stats()
            c0 = TABLE_CACHE.stats()
            bank.dispatch(_port_queue(mk()))
            c1 = TABLE_CACHE.stats()
            s = bank.stats
            got[key] = {"replays": s.batches,
                        "modeled_latency_s": s.total_latency_s,
                        "replay_latency_s": s.latency_s}
            if key == "fused":
                got[key].update(
                    fused_batches=s.fused_batches,
                    throughput_gops=s.throughput_gops,
                    throughput_total_gops=s.throughput_total_gops,
                    transpose_s=s.transpose_s,
                    transpositions_skipped=s.transpositions_skipped,
                    transpose_s_saved=s.transpose_s_saved,
                    table_cache_hits_per_dispatch=c1["hits"] - c0["hits"],
                    table_cache_misses_per_dispatch=(c1["misses"]
                                                     - c0["misses"]))
                fused_stats = s
            if key == "grouped":
                got[key]["transpose_s"] = s.transpose_s
        for key, fields in got.items():
            for field, v in fields.items():
                assert v == want[key][field], (name, key, field)
        assert want["replay_ratio"] == got["grouped"]["replays"] / max(
            got["fused"]["replays"], 1)
        for field, v in fused_stats.as_dict().items():
            gauge = f"bank.{name}.{field}"
            if field not in MEASURED and gauge in report["registry"]:
                assert report["registry"][gauge] == pytest.approx(
                    float(v), rel=0, abs=0), gauge
    comp = report["compaction"]
    before = after = 0
    for style in ("mig", "aig"):
        for op in ALL_OPS:
            before += compile_op(op, 8, style, compact=False)[1].n_activations
            after += compile_op(op, 8, style)[1].n_activations
    assert (before, after) == (comp["activations_uncompacted"],
                               comp["activations_compacted"])
