"""The port's compiler (Steps 1-2.5) mirrored from the reference's tests.

Mirrors, at the reference's widths, ``tests/test_logic.py``,
``test_uprogram.py``, ``test_allocation_properties.py``,
``test_compaction.py``, ``test_ops_library.py``,
``test_shift_and_csa.py`` and ``test_eval_models.py``, on the CPU: each
case runs the port's code and holds it against the reference's oracles,
circuits, compiled programs, reports and models where they are cheap to
get (``tests/test_torch_compiler.py`` already holds every 8- and 16-bit
command table byte for byte).  Hypothesis cases run with
``deadline=None`` and a fixed ``max_examples``; their random circuits are
built in both packages from one drawn recipe.  The cases that compile
16- and 32-bit multiplication and division (about 90 s of pure Python)
are in ``test_torch_compiler_mirror_wide.py``.

A circuit whose output simplifies to a constant: ``evaluate_outputs``
returns the ``zero`` or ``one`` it was given for that output (a scalar
``np.uint64`` here), not an array of the input's shape, in the port as
in the reference (``test_constant_output_is_the_scalar_given``); the
mirrors compare outputs broadcast to the lanes.  (The reference's own
``test_synthesis_preserves_semantics`` compares them unbroadcast, which
fails when Hypothesis draws such a circuit.)
"""

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from test_torch_examples_core import one_torch_thread  # noqa: F401
from repro.core import allocation as ref_alloc
from repro.core import logic as ref_logic
from repro.core import synthesis as ref_synth
from repro.core.isa import compile_op as ref_compile_op
from repro.core.ops_library import get_op as ref_get_op
from repro_torch.core import area, costmodel, energy, reliability, timing
from repro_torch.core import logic, synthesis
from repro_torch.core.allocation import compile_circuit
from repro_torch.core.control_unit import (encode_uprogram, load_state,
                                           make_interpreter, read_outputs)
from repro_torch.core.isa import SimdramDevice, compile_op, compile_shift
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.subarray import Subarray, pack_bits, run_op
from repro_torch.core.uprogram import (C0, C1, DCC_ROWS, N_SPECIAL,
                                       ROWHAMMER_STREAK_BOUND, TRIPLES,
                                       max_activation_streak)

U = np.uint64
ONE = ~U(0)
CPU = "cpu"


def _same_outputs(got, want, lanes):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.broadcast_to(np.asarray(a), lanes),
                                      np.broadcast_to(np.asarray(b), lanes))


# --------------------------------------------------------------------------
# tests/test_logic.py
# --------------------------------------------------------------------------

def test_peephole_identities():
    """The same identities, with the reference's node ids."""
    got, want = [], []
    for mod, out in ((logic, got), (ref_logic, want)):
        c = mod.Circuit()
        a, b = c.input("a"), c.input("b")
        out += [c.AND(a, a), c.OR(a, a), c.XOR(a, a), c.const(0),
                c.NOT(c.NOT(a)), c.AND(a, c.const(0)), c.AND(a, c.const(1)),
                c.MAJ(a, a, b), c.MAJ(a, c.NOT(a), b), c.AND(a, b),
                c.AND(b, a), a, b]
    assert got == want
    c_and_aa, c_or_aa, c_xor_aa, c0, c_nn, c_and0, c_and1, m1, m2, ab, ba, \
        a, b = got
    assert c_and_aa == a and c_or_aa == a and c_xor_aa == c0
    assert c_nn == a and c_and0 == c0 and c_and1 == a
    assert m1 == a and m2 == b and ab == ba


def test_maj_truth_table():
    c = logic.Circuit()
    x, y, z = (c.input(s) for s in "xyz")
    c.mark_output(c.MAJ(x, y, z), "m")
    for bits in range(8):
        vals = {x: ONE if bits & 1 else U(0), y: ONE if bits & 2 else U(0),
                z: ONE if bits & 4 else U(0)}
        (out,) = c.evaluate_outputs(vals, U(0), ONE)
        assert out == (ONE if bin(bits).count("1") >= 2 else U(0))


def test_maj_full_adder_exhaustive():
    c = logic.Circuit()
    a, b, ci = (c.input(s) for s in "abc")
    s, co = synthesis.maj_full_adder(c, a, b, ci)
    c.mark_output(s, "s")
    c.mark_output(co, "c")
    for bits in range(8):
        va, vb, vc = bits & 1, (bits >> 1) & 1, (bits >> 2) & 1
        vals = {a: ONE if va else U(0), b: ONE if vb else U(0),
                ci: ONE if vc else U(0)}
        s_o, c_o = c.evaluate_outputs(vals, U(0), ONE)
        total = va + vb + vc
        assert (s_o == ONE) == bool(total & 1)
        assert (c_o == ONE) == (total >= 2)


@st.composite
def circuit_recipe(draw, n_in=(2, 5), n_gates=(1, 25), n_out=None):
    """A random circuit as data: inputs, gates over earlier nodes (the
    inputs, then const 0 and 1, then the gates), outputs."""
    k = draw(st.integers(*n_in))
    gates = []
    for g in range(draw(st.integers(*n_gates))):
        op = draw(st.sampled_from(["and", "or", "xor", "not", "maj"]))
        n_args = {"not": 1, "maj": 3}.get(op, 2)
        gates.append((op, [draw(st.integers(0, k + 1 + g))
                           for _ in range(n_args)]))
    n_nodes = k + 2 + len(gates)
    outs = ([n_nodes - 1, n_nodes // 2] if n_out is None else
            [draw(st.integers(0, n_nodes - 1))
             for _ in range(draw(st.integers(*n_out)))])
    return k, gates, outs


def build(mod, recipe):
    """The recipe's circuit in package ``mod``'s ``logic``: (circuit,
    input ids)."""
    k, gates, outs = recipe
    c = mod.Circuit()
    inputs = [c.input(f"i{j}") for j in range(k)]
    nodes = list(inputs) + [c.const(0), c.const(1)]
    for op, args in gates:
        picked = [nodes[a] for a in args]
        nodes.append(c.NOT(*picked) if op == "not" else
                     getattr(c, op.upper())(*picked))
    for i, o in enumerate(outs):
        c.mark_output(nodes[o], f"o{i}")
    return c, inputs


def _rand_inputs(c, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {nid: np.where(rng.integers(0, 2, size=n) == 1, ONE, U(0))
            for nid in range(len(c.ops)) if c.ops[nid] == "in"}


@given(circuit_recipe())
@settings(max_examples=60, deadline=None)
def test_synthesis_preserves_semantics(recipe):
    """AIG->MIG->optimize is semantics-preserving on random circuits, and
    the port's MIG is the reference's, node for node."""
    circ, _ = build(logic, recipe)
    mig, _ = synthesis.synthesize(circ)
    assert mig.is_mig()
    ref_mig, _ = ref_synth.synthesize(build(ref_logic, recipe)[0])
    assert (mig.ops, mig.args, mig.outputs, mig.names) == (
        ref_mig.ops, ref_mig.args, ref_mig.outputs, ref_mig.names)
    dst_in = {mig.names[i]: i for i in range(len(mig.ops))
              if mig.ops[i] == "in"}
    vals_src = _rand_inputs(circ)
    vals_dst = {dst_in[circ.names[nid]]: v for nid, v in vals_src.items()
                if circ.names[nid] in dst_in}
    _same_outputs(mig.evaluate_outputs(vals_dst, U(0), ONE),
                  circ.evaluate_outputs(vals_src, U(0), ONE), 64)


def test_constant_output_is_the_scalar_given():
    """``x AND NOT x`` simplifies to the constant 0: both packages'
    ``evaluate_outputs`` return the ``zero`` given (a scalar), not an
    array of the inputs' shape; the live output is an array."""
    outs = []
    for mod in (logic, ref_logic):
        c = mod.Circuit()
        x = c.input("x")
        c.mark_output(c.AND(x, c.NOT(x)), "zero")
        c.mark_output(x, "x")
        mig, _ = (synthesis if mod is logic else ref_synth).synthesize(c)
        vals = {i: np.full(64, ONE) for i in range(len(mig.ops))
                if mig.ops[i] == "in"}
        outs.append(mig.evaluate_outputs(vals, U(0), ONE))
    for zero, live in outs:
        assert isinstance(zero, np.uint64) and zero == 0
        assert np.asarray(zero).shape == () and live.shape == (64,)


@given(circuit_recipe())
@settings(max_examples=30, deadline=None)
def test_optimize_never_grows(recipe):
    mig = synthesis.to_mig(build(logic, recipe)[0])
    opt = synthesis.optimize_mig(mig)
    n0 = sum(1 for n in mig.live_nodes() if mig.ops[n] == logic.MAJ)
    n1 = sum(1 for n in opt.live_nodes() if opt.ops[n] == logic.MAJ)
    assert n1 <= n0
    ref_opt = ref_synth.optimize_mig(
        ref_synth.to_mig(build(ref_logic, recipe)[0]))
    assert n1 == sum(1 for n in ref_opt.live_nodes()
                     if ref_opt.ops[n] == ref_logic.MAJ)


# --------------------------------------------------------------------------
# tests/test_uprogram.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["mig", "aig"])
@pytest.mark.parametrize("name", ALL_OPS)
def test_uprogram_matches_oracle(name, style):
    n = 8
    spec, up = compile_op(name, n, style)
    rng = np.random.default_rng(3)
    ops_vals = [rng.integers(0, 1 << w, size=96).astype(np.uint64)
                for w in spec.operand_bits]
    got = run_op(up, spec.out_bits, ops_vals, n_columns=96 + (32 - 96 % 32))
    want = ref_get_op(name, n).oracle(*ops_vals)
    for gi, (g, e) in enumerate(zip(got, want)):
        mask = np.uint64((1 << spec.out_bits[gi]) - 1)
        np.testing.assert_array_equal(g & mask, e & mask,
                                      err_msg=f"{name}/{style}")


def test_no_op_is_worse_than_ambit():
    for name in ALL_OPS:
        _, up_sd = compile_op(name, 8, "mig")
        _, up_am = compile_op(name, 8, "aig")
        assert up_sd.n_activations <= up_am.n_activations, name
        assert (up_sd.n_activations, up_am.n_activations) == (
            ref_compile_op(name, 8, "mig")[1].n_activations,
            ref_compile_op(name, 8, "aig")[1].n_activations)


def test_constant_rows_are_readonly():
    sa = Subarray(16, 64)
    with pytest.raises(ValueError):
        sa.write((C0, False), np.zeros(2, np.uint32))
    assert (sa.rows[C1] == 0xFFFFFFFF).all()


def test_dcc_negation_semantics():
    sa = Subarray(16, 64)
    d0 = DCC_ROWS[0]
    val = np.arange(2, dtype=np.uint32)
    sa.rows[N_SPECIAL] = val
    sa.aap((N_SPECIAL, False), (d0, False))
    assert (sa.read((d0, True)) == ~val).all()
    sa.aap((N_SPECIAL, False), (d0, True))
    assert (sa.read((d0, False)) == ~val).all()


def test_activation_count_consistency():
    _, up = compile_op("addition", 8, "mig")
    assert up.n_activations == 2 * up.n_aap + up.n_ap
    assert len(up.commands) == up.n_aap + up.n_ap


# --------------------------------------------------------------------------
# tests/test_allocation_properties.py
# --------------------------------------------------------------------------

PROGRAM = circuit_recipe(n_in=(2, 6), n_gates=(3, 40), n_out=(1, 4))


def _compile_both(recipe):
    """The recipe's synthesized MIG compiled by both packages, or None
    where no MAJ is left (the allocator's trivial case)."""
    compiled = []
    for lg, syn, compile_fn in ((logic, synthesis, compile_circuit),
                                (ref_logic, ref_synth,
                                 ref_alloc.compile_circuit)):
        circ, inputs = build(lg, recipe)
        mig, _ = syn.synthesize(circ)
        name2id = {mig.names[i]: i for i in range(len(mig.ops))
                   if mig.ops[i] == "in"}
        live = [i for i in inputs if circ.names[i] in name2id]
        if not any(mig.ops[n] == "maj" for n in mig.live_nodes()):
            return None
        ids = [[name2id[circ.names[i]]] for i in live]
        compiled.append((circ, mig, name2id, live,
                         compile_fn(mig, ids, op_name="prop", n_bits=1)))
    assert [(c.kind, c.src, c.dst, c.triple)
            for c in compiled[0][4].commands] == [
        (c.kind, c.src, c.dst, c.triple) for c in compiled[1][4].commands]
    return compiled[0]


@given(PROGRAM, st.integers(0, 2**31 - 1))
@settings(max_examples=40, deadline=None)
def test_compiled_uprogram_matches_circuit(recipe, seed):
    """Any random MIG compiles (to the reference's commands) into a
    μProgram whose subarray execution equals the circuit's evaluation."""
    got = _compile_both(recipe)
    if got is None:
        return
    circ, mig, name2id, live, up = got
    rng = np.random.default_rng(seed)
    cols = 64
    bits = {i: rng.integers(0, 2, size=cols).astype(np.uint64) for i in live}
    vals = {name2id[circ.names[i]]: np.where(b == 1, ONE, U(0))
            for i, b in bits.items()}
    want = mig.evaluate_outputs(vals, U(0), ONE)
    sa = Subarray(up.n_rows_total, cols)
    for op_idx, rows in enumerate(up.in_rows):
        sa.rows[rows[0]] = pack_bits(bits[live[op_idx]], 1, cols)[0]
    sa.execute(up.commands)
    for oi, rows in enumerate(up.out_rows):
        w = np.broadcast_to(np.asarray(want[oi] & U(1), np.uint64), (cols,))
        np.testing.assert_array_equal(
            sa.rows[rows[0]], pack_bits(np.ascontiguousarray(w), 1, cols)[0],
            err_msg=f"out{oi}")


@given(PROGRAM)
@settings(max_examples=25, deadline=None)
def test_constant_rows_never_written(recipe):
    """The allocator never emits a command writing C0/C1."""
    got = _compile_both(recipe)
    if got is None:
        return
    for cmd in got[4].commands:
        if cmd.kind == "AAP":
            assert cmd.dst[0] not in (C0, C1), cmd
        else:
            for r, _neg in TRIPLES[cmd.triple]:
                assert r not in (C0, C1)


# --------------------------------------------------------------------------
# tests/test_compaction.py
# --------------------------------------------------------------------------

def _run_table(spec, uprog, operands, lanes):
    """One μProgram through the control unit's replay (the plain version
    of K5 on the CPU), its outputs read back."""
    cols = lanes + (-lanes) % 32
    state = load_state(uprog, operands, cols)
    out = make_interpreter(CPU)(state, encode_uprogram(uprog))
    return read_outputs(spec.out_bits, uprog,
                        out.numpy().view(np.uint32), lanes)


_CASES = [(op, style) for op in ALL_OPS for style in ("mig", "aig")
          if style == "mig" or op not in ("division", "multiplication")]


@given(st.sampled_from(_CASES), st.sampled_from([8, 16]),
       st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_compaction_preserves_semantics(case, n_bits, seed):
    op, style = case
    rng = np.random.default_rng(seed)
    spec, up_u = compile_op(op, n_bits, style, compact=False)
    _, up_c = compile_op(op, n_bits, style, compact=True)
    operands = [rng.integers(0, 1 << w, 96).astype(np.uint64)
                for w in spec.operand_bits]
    want = _run_table(spec, up_u, operands, 96)
    got = _run_table(spec, up_c, operands, 96)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, e, err_msg=f"{op}/{n_bits}/{style}")


@pytest.mark.parametrize("style", ["mig", "aig"])
def test_compaction_never_increases_activations(style):
    for op in ALL_OPS:
        _, up_u = compile_op(op, 8, style, compact=False)
        _, up_c = compile_op(op, 8, style, compact=True)
        assert up_c.n_activations <= up_u.n_activations, (op, style)
        assert up_c.n_rows_total <= up_u.n_rows_total, (op, style)
        assert len(up_c.commands) <= len(up_u.commands), (op, style)
        assert (max_activation_streak(up_c.commands)
                <= max(max_activation_streak(up_u.commands),
                       ROWHAMMER_STREAK_BOUND)), (op, style)


def test_compaction_reduces_library_total():
    before = after = 0
    for op in ALL_OPS:
        before += compile_op(op, 8, "mig", compact=False)[1].n_activations
        after += compile_op(op, 8, "mig", compact=True)[1].n_activations
    assert after < before


def test_compact_is_idempotent_and_reported():
    """The report's numbers are the reference's."""
    _, up_u = compile_op("subtraction", 8, "mig", compact=False)
    up_c, report = synthesis.compact(up_u)
    _, ref_report = ref_synth.compact(
        ref_compile_op("subtraction", 8, "mig", compact=False)[1])
    assert (report.before_activations, report.after_activations,
            report.removed_activations, report.reduction) == (
        ref_report.before_activations, ref_report.after_activations,
        ref_report.removed_activations, ref_report.reduction)
    assert report.before_activations == up_u.n_activations
    assert report.after_activations == up_c.n_activations
    assert report.removed_activations > 0
    assert 0.0 < report.reduction < 1.0
    again, report2 = synthesis.compact(up_c)
    assert again.n_activations == up_c.n_activations
    assert report2.removed_activations == 0


def test_cached_tables_are_compacted():
    from repro_torch.core.bank import cached_table
    _, up_c = compile_op("addition", 8, "mig", compact=True)
    _, uprog, table = cached_table("addition", 8, "mig")
    assert uprog.n_activations == up_c.n_activations
    assert table.shape[0] >= len(up_c.commands)


def test_nop_padding_words_compact_away():
    from repro_torch.core.uprogram import Command, compact_commands
    _, up = compile_op("greater", 8, "mig")
    padded = list(up.commands) + [Command("AAP", src=(0, False),
                                          dst=(0, False))] * 17
    live = {r for rows in up.out_rows for r in rows}
    assert len(compact_commands(padded, live)) <= len(up.commands)


# --------------------------------------------------------------------------
# tests/test_ops_library.py
# --------------------------------------------------------------------------

def _run_circuit(spec, style, ops_vals):
    c, ids = spec.build(style)
    inputs = {}
    for op_ids, val in zip(ids, ops_vals):
        for i, nid in enumerate(op_ids):
            inputs[nid] = np.where(((val >> U(i)) & U(1)) == 1, ONE, U(0))
    outs = c.evaluate_outputs(inputs, U(0), ONE)
    res, pos = [], 0
    for w in spec.out_bits:
        acc = np.zeros_like(ops_vals[0])
        for i in range(w):
            acc |= (outs[pos + i] & U(1)) << U(i)
        res.append(acc)
        pos += w
    return res


def _check_circuit(name, n_bits, style, ops_vals):
    spec = get_op(name, n_bits)
    got = _run_circuit(spec, style, ops_vals)
    want = ref_get_op(name, n_bits).oracle(*ops_vals)
    for gi, (g, e) in enumerate(zip(got, want)):
        mask = U((1 << spec.out_bits[gi]) - 1)
        np.testing.assert_array_equal(g & mask, e & mask,
                                      err_msg=f"{name}/{style}/out{gi}")


@pytest.mark.parametrize("style", ["aig", "mig"])
@pytest.mark.parametrize("name", ALL_OPS)
def test_op_exhaustive_4bit(name, style):
    widths = get_op(name, 4).operand_bits
    if sum(widths) <= 12:
        combos = np.arange(1 << sum(widths), dtype=np.uint64)
        ops_vals, shift = [], 0
        for w in widths:
            ops_vals.append((combos >> U(shift)) & U((1 << w) - 1))
            shift += w
    else:
        rng = np.random.default_rng(1)
        ops_vals = [rng.integers(0, 1 << w, size=2048).astype(np.uint64)
                    for w in widths]
    _check_circuit(name, 4, style, ops_vals)


@pytest.mark.parametrize("name", ALL_OPS)
@pytest.mark.parametrize("n_bits", [8, 16])
def test_op_random_wide(name, n_bits):
    rng = np.random.default_rng(n_bits)
    ops_vals = [rng.integers(0, 1 << w, size=512).astype(np.uint64)
                for w in get_op(name, n_bits).operand_bits]
    _check_circuit(name, n_bits, "mig", ops_vals)


def test_registry_has_exactly_16():
    from repro.core.ops_library import ALL_OPS as REF_ALL_OPS
    assert len(ALL_OPS) == 16 and list(ALL_OPS) == list(REF_ALL_OPS)


# --------------------------------------------------------------------------
# tests/test_shift_and_csa.py
# --------------------------------------------------------------------------

def test_shift_costs_zero_commands():
    _, up = compile_shift(8, 3)
    assert up.n_activations == 0 and not up.commands


@pytest.mark.parametrize("k", [-3, -1, 0, 1, 4, 7])
def test_shift_matches_python(k):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=70).astype(np.int64)
    dev = SimdramDevice(backend="subarray", device=CPU)
    got = dev.bbop_shift(x, k, n_bits=8)
    want = ((x << k) if k >= 0 else (x >> -k)) & 0xFF
    np.testing.assert_array_equal(got & 0xFF, want)
    assert dev.totals()["latency_s"] == 0.0


# --------------------------------------------------------------------------
# tests/test_eval_models.py
# --------------------------------------------------------------------------

def test_throughput_scales_with_banks():
    _, up = compile_op("addition", 16)
    t1 = timing.throughput_gops(up, timing.DramConfig(n_banks=1))
    t16 = timing.throughput_gops(up, timing.DramConfig(n_banks=16))
    assert abs(t16 / t1 - 16.0) < 1e-6


def test_simdram_beats_cpu_gpu_on_throughput_and_energy():
    from repro.core import energy as ref_energy
    from repro.core import timing as ref_timing
    _, up = compile_op("addition", 8)
    _, ref_up = ref_compile_op("addition", 8)
    sd = timing.throughput_gops(up, timing.DDR4)
    assert sd == ref_timing.throughput_gops(ref_up, ref_timing.DDR4)
    cpu = timing.host_throughput_gops(8, 2, 1, timing.CPU_BASELINE)
    assert sd / cpu > 10
    e_sd = energy.energy_per_elem_pj(up)
    assert e_sd == ref_energy.energy_per_elem_pj(ref_up)
    e_cpu = energy.host_energy_per_elem_pj(8, 2, 1, timing.CPU_BASELINE)
    assert e_cpu / e_sd > 10


def test_area_claim():
    from repro.core.area import DEFAULT_AREA as REF_AREA
    rep = area.DEFAULT_AREA.report()
    assert rep == REF_AREA.report()
    assert rep["meets_paper_claim_lt_1pct"]
    assert rep["total_dram_frac"] < 0.01


def test_reliability_monotone_in_sigma():
    from repro.core import reliability as ref_rel
    rates = [reliability.tra_failure_rate(
        s, reliability.TECH_NODES["17nm"], 50_000) for s in
        (0.0, 0.1, 0.2, 0.3)]
    assert rates == [ref_rel.tra_failure_rate(
        s, ref_rel.TECH_NODES["17nm"], 50_000) for s in (0.0, 0.1, 0.2, 0.3)]
    assert rates[0] == 0.0
    assert rates[-1] > rates[1]
    assert all(a <= b + 1e-9 for a, b in zip(rates, rates[1:]))


def test_reliability_fine_at_realistic_variation():
    for node, cell in reliability.TECH_NODES.items():
        assert reliability.tra_failure_rate(0.10, cell, 50_000) < 1e-4, node


def test_costmodel_monotone_in_size():
    small = costmodel.decide("addition", 8, 1 << 10)
    big = costmodel.decide("addition", 8, 1 << 24)
    assert big.speedup > small.speedup


def test_costmodel_prefers_vertical_operands():
    from repro.core.costmodel import decide as ref_decide
    cold = costmodel.decide("addition", 8, 1 << 20, operands_vertical=0)
    warm = costmodel.decide("addition", 8, 1 << 20, operands_vertical=2,
                            result_stays_vertical=True)
    assert warm.pum_total_s < cold.pum_total_s
    assert warm.speedup > cold.speedup
    ref_warm = ref_decide("addition", 8, 1 << 20, operands_vertical=2,
                          result_stays_vertical=True)
    assert (warm.offload, warm.host_s, warm.pum_total_s, warm.speedup) == (
        ref_warm.offload, ref_warm.host_s, ref_warm.pum_total_s,
        ref_warm.speedup)
