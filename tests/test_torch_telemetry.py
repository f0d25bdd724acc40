"""Telemetry on the port against the JAX package, on the CPU.

Mirrors ``tests/test_telemetry.py`` case by case on the port's engines
(``device="cpu"``): span nesting across bank → chip → channel → rank,
bit-for-bit reconciliation of the modeled clock with the ``*Stats``
accumulators, the flight recorder on fault exhaustion and on the serve
tier's host fallback, the disabled tracer's freedom, the shared
``_FIELD_SPEC`` serialization, the registry and the exporters (checked
with ``scripts/check_trace.py``).  Then the cross-package parity: the
same queue on bank, chip, channel and rank, and on the fault path, under
both packages' tracers gives the same span tree ``(name, cat, lane,
depth)``, the same attributes and ``charges`` span by span, ``==``
``modeled_total`` in every category, the same incidents, the same
``publish_stats`` snapshot and the same modeled (pid 2) Chrome events.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.core import bank as ref_bank
from repro.core import channel as ref_channel
from repro.core import chip as ref_chip
from repro.core import control_unit as ref_cu
from repro.core import fault as ref_fault
from repro.core import rank as ref_rank
from repro.core.isa import SimdramDevice as RefDevice
from repro.core.telemetry import MetricsRegistry as RefRegistry
from repro_torch import obs
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.bank import Bank, BankStats, flatten_result
from repro_torch.core.channel import ChannelStats, SimdramChannel
from repro_torch.core.chip import ChipStats, SimdramChip
from repro_torch.core.fault import FaultExhaustedError, FaultModel, FaultStats
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.rank import SimdramRank
from repro_torch.core.telemetry import (MetricsRegistry, Tracer,
                                        collect_field_spec)

U = np.uint64
REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def _queue(lanes=64, seed=0, mod=pt_bank):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, lanes).astype(U)
    b = rng.integers(0, 256, lanes).astype(U)
    return [
        mod.BbopInstr("addition", (a, b), 8),
        mod.BbopInstr("multiplication", (mod.Ref(0), b), 8),
        mod.BbopInstr("greater", (a, b), 8),
    ]


def _exact(xs, ys):
    return all(np.array_equal(np.asarray(p), np.asarray(q))
               for x, y in zip(xs, ys)
               for p, q in zip(flatten_result(x), flatten_result(y)))


# ---------------------------------------------------------------------------
# tracer mechanics
# ---------------------------------------------------------------------------

def test_disabled_by_default_and_facade_noops():
    assert obs.active_tracer() is None
    # the facade is safe (and free) without a tracer installed
    with obs.span("anything") as sp:
        assert sp is None
    obs.charge("cat", 1.0)
    assert obs.incident("nope") is None
    assert obs.incidents() == []


def test_span_nesting_charges_and_unwind():
    tr = Tracer()
    root = tr.begin("root", cat="dispatch")
    with tr.span("child", lane="bank0") as child:
        tr.charge("replay", 1.0)
        grand = tr.begin("grand")
        assert grand.lane == "bank0"     # lane inherits from the parent
        tr.charge("replay", 2.0)
        tr.end(grand)
    tr.charge("other", 0.5)
    tr.end(root)

    assert tr.depth == 0
    assert list(tr.roots) == [root]
    assert [s.name for s in root.walk()] == ["root", "child", "grand"]
    assert child.modeled_s == 1.0            # exclusive
    assert child.modeled_total_s == 3.0      # inclusive of grand
    assert root.modeled_total_s == 3.5
    assert tr.modeled_total("replay") == 3.0
    assert tr.modeled_categories() == ("other", "replay")
    assert root.find("grand") == [grand]
    assert all(s.wall_s >= 0.0 for s in root.walk())

    # exception recovery: unwind closes everything an abort left open
    depth0 = tr.depth
    tr.begin("attempt")
    tr.begin("deep")
    assert tr.depth == depth0 + 2
    tr.unwind(depth0, aborted=True)
    assert tr.depth == depth0
    assert tr.roots[-1].name == "attempt"
    assert tr.roots[-1].attrs["aborted"] is True


def test_enabled_scope_restores_previous_tracer():
    assert obs.active_tracer() is None
    with obs.enabled() as tr:
        assert obs.active_tracer() is tr
        with obs.enabled() as inner:
            assert obs.active_tracer() is inner
        assert obs.active_tracer() is tr
    assert obs.active_tracer() is None


def test_flight_recorder_ring_is_bounded():
    tr = Tracer(max_dispatches=3)
    for i in range(5):
        with tr.span(f"d{i}"):
            pass
    assert [r.name for r in tr.roots] == ["d2", "d3", "d4"]
    rec = tr.incident("why", detail=7)
    assert rec.reason == "why" and rec.attrs == {"detail": 7}
    assert [r.name for r in rec.roots] == ["d2", "d3", "d4"]
    assert rec.open_spans == []


def test_launch_timing_needs_an_open_replay_span_and_a_card():
    """The device clock records CUDA events only for a launch on a card
    inside an open ``*.replay`` span: on the CPU, or outside such a
    span, no event is made and no ``device_s`` appears."""
    import torch
    tr = Tracer()
    with tr.span("bank.replay"):
        assert tr.launch_begin(torch.device("cpu")) is None
        tr.launch_end(None)
    with tr.span("bank.pack_wave"):
        assert tr.launch_begin(torch.device("cpu")) is None
    tr.resolve_device()
    assert all("device_s" not in s.attrs
               for r in tr.roots for s in r.walk())


# ---------------------------------------------------------------------------
# dual-clock reconciliation against the Stats accumulators (bit-for-bit)
# ---------------------------------------------------------------------------

def test_bank_dual_clock_reconciles_bit_exact():
    ref = Bank(n_subarrays=2, device=CPU).dispatch(_queue())
    with obs.enabled() as tr:
        bank = Bank(n_subarrays=2, device=CPU)
        out = bank.dispatch(_queue())
        st = bank.stats
        assert tr.modeled_total("bank.replay") == st.latency_s
        assert tr.modeled_total("transpose") == st.transpose_s
        assert tr.modeled_total("transpose_saved") == st.transpose_s_saved
        roots = list(tr.roots)
    assert _exact(out, ref)
    assert len(roots) == 1 and roots[0].name == "bank.dispatch"
    assert roots[0].wall_s > 0.0


def test_span_nesting_across_the_ladder():
    with obs.enabled() as tr:
        ch = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2, device=CPU)
        ch.dispatch(_queue(lanes=128))
        st = ch.stats
        assert tr.modeled_total("channel.replay") == st.latency_s
        assert (tr.modeled_total("channel.transfer.h2d")
                == st.transfer_h2d_s)
        assert (tr.modeled_total("channel.transfer.d2h")
                == st.transfer_d2h_s)
        assert (tr.modeled_total("channel.transfer.overlapped")
                == st.transfer_overlapped_s)
        root = tr.roots[-1]
    assert root.name == "channel.dispatch"
    names = {s.name for s in root.walk()}
    assert {"channel.pack_super_round", "chip.pack_round",
            "bank.pack_wave", "channel.replay",
            "channel.transfer.h2d", "channel.unpack"} <= names
    lanes = {s.lane for s in root.walk()}
    assert "chip0" in lanes and any("/bank" in ln for ln in lanes)


def test_transfer_charges_reconcile_span_by_span():
    """Folding every span's ordered ``charges`` list reproduces
    ``modeled_total`` AND the Stats accumulators exactly (``==``) — at
    the channel tier and at the rank tier (where ``rank.*`` categories
    own the shared host link and ``channel.busy`` carries each member
    channel's replay time)."""
    with obs.enabled() as tr:
        ch = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device=CPU)
        ch.dispatch(_queue(lanes=128))
        st = ch.stats
        for cat, want in (("channel.transfer.h2d", st.transfer_h2d_s),
                          ("channel.transfer.d2h", st.transfer_d2h_s),
                          ("channel.transfer.overlapped",
                           st.transfer_overlapped_s)):
            assert tr.modeled_total(cat) == want
            folded = 0.0
            for root in tr.roots:
                for sp in root.walk():
                    for c, s in sp.charges:
                        if c == cat:
                            folded += s
            assert folded == want
        # every transfer span is byte-annotated and burst-aligned
        spans = [s for root in tr.roots for s in root.walk()
                 if s.name.startswith("channel.transfer.")
                 and s.name != "channel.transfer.overlapped"]
        assert spans
        assert all(s.attrs["bytes"] > 0 for s in spans)
        assert sum(s.attrs["bytes"] for s in spans) == st.transfer_bytes

    with obs.enabled() as tr:
        rank = SimdramRank(use_shard_map=False, device=CPU)
        rank.dispatch(_queue(lanes=128))
        st = rank.stats
        assert tr.modeled_total("rank.transfer.h2d") == st.transfer_h2d_s
        assert tr.modeled_total("rank.transfer.d2h") == st.transfer_d2h_s
        assert (tr.modeled_total("rank.transfer.overlapped")
                == st.transfer_overlapped_s)
        assert tr.modeled_total("rank.replay") == st.latency_s
        # member channels charge their busy time but never the link
        assert tr.modeled_total("channel.busy") == sum(
            ch.stats.latency_s for ch in rank.channels)
        assert "channel.transfer.h2d" not in tr.modeled_categories()


def test_disabled_tracer_and_disabled_overlap_add_no_launches():
    """Neither knob touches the replay: dispatching with telemetry off,
    on, and with ``transfer_overlap=False`` leaves ``kernel_counts()``
    as it was (the CPU runs the plain replays) — and the overlap knob
    changes no results and no link charges, only the exposed/overlapped
    split."""
    from dataclasses import replace

    from repro_torch.core.control_unit import kernel_counts
    from repro_torch.core.timing import DDR4

    base = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2, device=CPU)
    r_base = base.dispatch(_queue(seed=5))
    t0 = kernel_counts()

    with obs.enabled():
        traced = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2,
                                device=CPU)
        r_traced = traced.dispatch(_queue(seed=5))
    assert kernel_counts() == t0             # tracer: no launch

    serial = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2,
                            cfg=replace(DDR4, transfer_overlap=False),
                            device=CPU)
    r_serial = serial.dispatch(_queue(seed=5))
    assert kernel_counts() == t0             # overlap knob: no launch

    assert _exact(r_traced, r_base) and _exact(r_serial, r_base)
    for eng in (traced, serial):
        assert eng.stats.transfer_h2d_s == base.stats.transfer_h2d_s
        assert eng.stats.transfer_d2h_s == base.stats.transfer_d2h_s
        assert eng.stats.latency_s == base.stats.latency_s
    assert serial.stats.transfer_overlapped_s == 0.0
    assert serial.stats.exposed_transfer_s == serial.stats.transfer_s


def test_traced_dispatch_changes_nothing():
    plain = Bank(n_subarrays=2, device=CPU)
    r_plain = plain.dispatch(_queue(seed=3))
    with obs.enabled():
        traced = Bank(n_subarrays=2, device=CPU)
        r_traced = traced.dispatch(_queue(seed=3))
    assert _exact(r_traced, r_plain)
    # the modeled cost model is identical with and without the tracer
    assert traced.stats.latency_s == plain.stats.latency_s
    assert traced.stats.transpose_s == plain.stats.transpose_s
    assert traced.stats.energy_nj == plain.stats.energy_nj
    assert obs.active_tracer() is None


# ---------------------------------------------------------------------------
# flight recorder on real incidents
# ---------------------------------------------------------------------------

def test_flight_recorder_captures_fault_exhaustion():
    with obs.enabled() as tr:
        bank = Bank(n_subarrays=2,
                    fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                     spare_lanes=1, seed=1,
                                     max_redispatches=1), device=CPU)
        with pytest.raises(FaultExhaustedError):
            bank.dispatch(_queue(lanes=32, seed=4))
        recs = [r for r in tr.incidents if r.reason == "fault_exhausted"]
        assert recs, "exhaustion must snapshot the flight recorder"
        assert recs[-1].attrs["cause"] in ("redispatch_budget",
                                           "no_capacity")
        # the aborted dispatch's spans were unwound — the stack is clean
        # and the next dispatch starts a fresh root, not a stale child
        assert tr.depth == 0
        clean = Bank(n_subarrays=2, device=CPU)
        clean.dispatch(_queue(lanes=32, seed=4))
        assert tr.roots[-1].name == "bank.dispatch"


def test_serve_host_fallback_records_incident_and_counter():
    from repro_torch.train.serve import PumServeOffload

    obs.reset()
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 48)).astype(np.float32)
    with obs.enabled() as tr:
        chip = SimdramChip(n_banks=2, n_subarrays=2,
                           fault=FaultModel(p_flip=0.0, dead_unit_rate=1.0,
                                            spare_lanes=1, seed=1,
                                            max_redispatches=1), device=CPU)
        off = PumServeOffload(chip=chip)
        out = off(logits)
        assert off.host_fallbacks == 1
        assert np.array_equal(out, off.reference(logits))
        reasons = [r.reason for r in tr.incidents]
        assert "serve_host_fallback" in reasons
        root = tr.roots[-1]
    assert root.name == "serve.offload"
    assert root.attrs.get("fallback") is True
    assert root.find("serve.host_fallback")
    assert obs.REGISTRY.counter("serve.host_fallbacks").value == 1.0


# ---------------------------------------------------------------------------
# shared field-spec serialization: one definition, three tiers
# ---------------------------------------------------------------------------

def test_field_spec_tiers_are_consistent_supersets():
    bank_spec = dict(collect_field_spec(BankStats))
    chip_spec = dict(collect_field_spec(ChipStats))
    chan_spec = dict(collect_field_spec(ChannelStats))
    assert set(bank_spec) <= set(chip_spec)
    assert set(bank_spec) <= set(chan_spec)
    assert {"rounds", "bank_busy_s"} <= set(chip_spec)
    assert {"super_rounds", "transfer_s"} <= set(chan_spec)
    # inherited keys keep their kind — no tier redefines a field's shape
    for key, kind in bank_spec.items():
        assert chip_spec[key] == kind and chan_spec[key] == kind


def test_as_dict_round_trips_through_the_spec():
    q = _queue(lanes=128)
    bank = Bank(n_subarrays=2, device=CPU)
    bank.dispatch(_queue(lanes=128))
    chip = SimdramChip(n_banks=2, n_subarrays=2, device=CPU)
    chip.dispatch(_queue(lanes=128))
    ch = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2, device=CPU)
    ch.dispatch(q)

    dicts = [bank.stats.as_dict(), chip.stats.as_dict(),
             ch.stats.as_dict()]
    assert set(dicts[0]) <= set(dicts[1])
    assert set(dicts[0]) <= set(dicts[2])
    for d in dicts:
        assert "faults" not in d
        json.dumps(d)        # JSON-serializable end to end
        spec = {k for k, kind in collect_field_spec(type(bank.stats))
                if kind != "stats_if_any"}
        assert spec <= set(d)
        assert d["throughput_total_gops"] <= d["throughput_gops"]
    fs = FaultStats()
    fs.injected = 3
    fs.overhead_s = 1e-6
    assert set(FaultStats().as_dict()) == set(fs.as_dict())
    assert fs.as_dict()["injected"] == 3


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_counters_gauges_histograms():
    reg = MetricsRegistry()
    reg.counter("a.hits").inc()
    reg.counter("a.hits").inc(2)
    reg.gauge("a.level").set(7)
    for v in (1.0, 3.0):
        reg.histogram("b.lat").observe(v)
    snap = reg.snapshot()
    assert snap["a.hits"] == 3.0 and snap["a.level"] == 7.0
    assert snap["b.lat.count"] == 2 and snap["b.lat.mean"] == 2.0
    assert snap["b.lat.min"] == 1.0 and snap["b.lat.max"] == 3.0
    assert set(reg.snapshot("a.")) == {"a.hits", "a.level"}
    assert reg.histogram("b.lat").percentile(50) == 1.0
    assert reg.histogram("b.lat").percentile(99) == 3.0
    reg.reset()
    assert reg.snapshot() == {}


def test_publish_stats_flattens_into_gauges():
    chip = SimdramChip(n_banks=2, n_subarrays=2,
                       fault=FaultModel(p_flip=1e-4, spare_lanes=1, seed=1),
                       device=CPU)
    chip.dispatch(_queue())
    reg = MetricsRegistry()
    flat = obs.publish_stats(chip.stats, "chip.mix", registry=reg)
    snap = reg.snapshot("chip.mix.")
    assert snap == {k: float(v) for k, v in flat.items()}
    assert snap["chip.mix.latency_s"] == chip.stats.latency_s
    assert snap["chip.mix.faults.injected"] == chip.stats.faults.injected
    assert snap["chip.mix.bank_busy_s.len"] == len(chip.stats.bank_busy_s)
    assert snap["chip.mix.bank_busy_s.sum"] == float(
        sum(chip.stats.bank_busy_s))


# ---------------------------------------------------------------------------
# exporters (the schema gate of scripts/check_trace.py)
# ---------------------------------------------------------------------------

def _load_check_trace():
    spec = importlib.util.spec_from_file_location(
        "check_trace", REPO / "scripts" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chrome_trace_export_passes_the_ci_schema_gate(tmp_path):
    with obs.enabled() as tr:
        ch = SimdramChannel(n_chips=2, n_banks=1, n_subarrays=2, device=CPU)
        ch.dispatch(_queue(lanes=128))
        trace = obs.write_chrome_trace(str(tmp_path / "trace.json"))
        n_spans = tr.n_spans
    reloaded = json.loads((tmp_path / "trace.json").read_text())
    assert reloaded["traceEvents"] == trace["traceEvents"]
    errors = _load_check_trace().check_trace(reloaded)
    assert errors == []
    x_events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in x_events} == {1, 2}
    measured = [e for e in x_events if e["pid"] == 1]
    assert len(measured) == n_spans
    totals = trace["otherData"]["modeled_totals_s"]
    assert totals["channel.replay"] == ch.stats.latency_s


def test_jsonl_and_stage_summary(tmp_path):
    with obs.enabled() as tr:
        bank = Bank(n_subarrays=2, device=CPU)
        bank.dispatch(_queue())
        path = tmp_path / "spans.jsonl"
        n = obs.write_jsonl(str(path))
        assert n == tr.n_spans > 0
        trace = obs.chrome_trace()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == n
    roots = [r for r in records if r["parent"] == -1]
    assert [r["name"] for r in roots] == ["bank.dispatch"]
    by_id = {r["id"]: r for r in records}
    assert all(r["parent"] in by_id for r in records if r["parent"] != -1)

    rows = {r["stage"]: r for r in obs.stage_summary(trace)}
    assert rows["bank.dispatch"]["count"] == 1
    assert rows["bank.dispatch"]["wall_us"] > 0.0
    assert rows["bank.dispatch"]["modeled_us"] == pytest.approx(
        sum(trace["otherData"]["modeled_totals_s"].values()) * 1e6,
        rel=1e-9)


# ---------------------------------------------------------------------------
# cross-package parity: the same queue under both tracers
# ---------------------------------------------------------------------------

def _engines(tier, fault=None, ref_fault_model=None):
    """(reference engine, port engine) of one tier at the reference
    tests' small sizes."""
    if tier == "bank":
        kw = dict(n_subarrays=2)
        return (ref_bank.Bank(**kw, fault=ref_fault_model),
                Bank(**kw, fault=fault, device=CPU))
    if tier == "chip":
        kw = dict(n_banks=2, n_subarrays=2)
        return (ref_chip.SimdramChip(**kw, fault=ref_fault_model),
                SimdramChip(**kw, fault=fault, device=CPU))
    if tier == "channel":
        kw = dict(n_chips=2, n_banks=2, n_subarrays=2)
        return (ref_channel.SimdramChannel(**kw, fault=ref_fault_model),
                SimdramChannel(**kw, fault=fault, device=CPU))
    return (ref_rank.SimdramRank(use_shard_map=False),
            SimdramRank(device=CPU))


def _tree(tr):
    """Every span of every root in walk order: (name, cat, lane, depth,
    attrs, charges)."""
    out = []

    def rec(sp, depth):
        out.append((sp.name, sp.cat, sp.lane, depth, dict(sp.attrs),
                    list(sp.charges)))
        for child in sp.children:
            rec(child, depth + 1)

    for root in tr.roots:
        rec(root, 0)
    return out


def _modeled_events(trace):
    """The Chrome trace's modeled (pid 2) events without their measured
    ``wall_s`` argument."""
    return [{**e, "args": {k: v for k, v in e.get("args", {}).items()
                           if k != "wall_s"}}
            for e in trace["traceEvents"] if e.get("pid") == 2]


def _traced_pair(run_ref, run_port):
    """Run both under their package's tracer, table caches cleared so
    the hit/miss events line up; returns the two tracers and the
    results (or the raised errors)."""
    ref_cu.TABLE_CACHE.clear()
    cu.TABLE_CACHE.clear()
    outs = []
    for enabled, run in ((ref_obs.enabled, run_ref), (obs.enabled, run_port)):
        with enabled() as tr:
            try:
                res = run()
            except Exception as e:   # compared below, kind and context
                res = e
            outs.append((tr, res))
    return outs


def _assert_same_trace(tr_ref, tr_port):
    a, b = _tree(tr_ref), _tree(tr_port)
    assert [x[:4] for x in a] == [x[:4] for x in b]
    assert [x[4] for x in a] == [x[4] for x in b]      # attrs
    assert [x[5] for x in a] == [x[5] for x in b]      # charges, ==
    assert tr_ref.modeled_categories() == tr_port.modeled_categories()
    for cat in tr_ref.modeled_categories():
        assert tr_ref.modeled_total(cat) == tr_port.modeled_total(cat), cat
    assert ([(r.reason, r.attrs, r.open_spans) for r in tr_ref.incidents]
            == [(r.reason, r.attrs, r.open_spans)
                for r in tr_port.incidents])
    assert (_modeled_events(ref_obs.chrome_trace(tracer=tr_ref))
            == _modeled_events(obs.chrome_trace(tracer=tr_port)))


@pytest.mark.parametrize("tier", ["bank", "chip", "channel", "rank"])
def test_span_tree_charges_and_exports_equal_the_reference(tier):
    """Bank, chip, channel and rank: the same queue (a Ref chain and an
    independent op, 128 lanes) gives the reference's span tree, attrs,
    charges, categories, modeled Chrome events and ``publish_stats``
    snapshot under the port's tracer; results and every modeled Stats
    field are ``==`` too."""
    engines = {}

    def run(pkg, mod):
        def go():
            eng = _engines(tier)[0 if pkg == "ref" else 1]
            engines[pkg] = eng
            return eng.dispatch(_queue(lanes=128, mod=mod))
        return go

    (tr_ref, out_ref), (tr_port, out_port) = _traced_pair(
        run("ref", ref_bank), run("port", pt_bank))
    assert _exact(out_port, out_ref)
    _assert_same_trace(tr_ref, tr_port)
    assert tr_port.n_spans > 0
    ref_reg, port_reg = RefRegistry(), MetricsRegistry()
    want = ref_obs.publish_stats(engines["ref"].stats, tier,
                                 registry=ref_reg)
    got = obs.publish_stats(engines["port"].stats, tier, registry=port_reg)
    measured = {f"{tier}.wall_s", f"{tier}.pack_wall_s"}
    strip = (lambda d: {k: v for k, v in d.items() if k not in measured})
    assert strip(got) == strip(want)
    assert set(got) == set(want)
    assert strip(port_reg.snapshot()) == strip(ref_reg.snapshot())


@pytest.mark.parametrize("tier", ["bank", "chip", "channel"])
@pytest.mark.parametrize("kind", ["stuck", "exhausted"])
def test_fault_path_spans_equal_the_reference(tier, kind):
    """The fault wrappers with no flips (numpy-drawn faults, so the two
    packages draw the same): a stuck-column run that the vote heals,
    and a dead-unit run that exhausts the redundancy budget — the
    ``fault.execute`` span, its inject/retry/vote/redispatch events,
    the ``fault`` charges, the unwind and the ``fault_exhausted``
    incident all equal the reference's."""
    if kind == "stuck":
        kw = dict(p_flip=0.0, stuck_lane_rate=0.02, spare_lanes=2, seed=3)
    else:
        kw = dict(p_flip=0.0, dead_unit_rate=1.0, spare_lanes=1, seed=1,
                  max_redispatches=1)
    lanes = 32

    def run(pkg):
        def go():
            if pkg == "ref":
                eng = _engines(tier, ref_fault_model=ref_fault.FaultModel(
                    **kw))[0]
                return eng.dispatch(_queue(lanes=lanes, seed=4,
                                           mod=ref_bank))
            eng = _engines(tier, fault=FaultModel(**kw))[1]
            return eng.dispatch(_queue(lanes=lanes, seed=4))
        return go

    (tr_ref, out_ref), (tr_port, out_port) = _traced_pair(
        run("ref"), run("port"))
    if kind == "stuck":
        assert _exact(out_port, out_ref)
    else:
        assert isinstance(out_ref, ref_fault.FaultExhaustedError)
        assert isinstance(out_port, FaultExhaustedError)
        assert out_port.context() == out_ref.context()
        assert tr_port.depth == 0
    names = {s.name for r in tr_port.roots for s in r.walk()}
    assert {"fault.execute", "fault.inject", "fault.vote"} <= names
    _assert_same_trace(tr_ref, tr_port)


def test_device_dispatch_spans_equal_the_reference():
    """``SimdramDevice.dispatch`` opens ``device.dispatch`` and
    ``device.validate`` around the engine's tree, and the lazily built
    engine's executor records its ``pum.executor`` event inside it."""
    (tr_ref, out_ref), (tr_port, out_port) = _traced_pair(
        lambda: RefDevice(backend="channel").dispatch(
            _queue(mod=ref_bank)),
        lambda: SimdramDevice(backend="channel", device=CPU).dispatch(
            _queue()))
    assert _exact(out_port, out_ref)
    root = tr_port.roots[-1]
    assert root.name == "device.dispatch"
    assert root.find("device.validate") and root.find("pum.executor")
    _assert_same_trace(tr_ref, tr_port)


def test_engine_stats_object_publishes_as_the_reference():
    """The apps' ``engine_stats_object`` goes through ``publish_stats``
    to the reference's flattened keys and gauge values."""
    from repro.apps import runtime as ref_runtime
    from repro_torch.apps import runtime

    ref_dev = RefDevice(backend="chip")
    dev = SimdramDevice(backend="chip", device=CPU)
    ref_dev.dispatch(_queue(mod=ref_bank))
    dev.dispatch(_queue())
    want = ref_obs.publish_stats(ref_runtime.engine_stats_object(ref_dev),
                                 "apps.chip", registry=RefRegistry())
    got = obs.publish_stats(runtime.engine_stats_object(dev), "apps.chip",
                            registry=MetricsRegistry())
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if "wall" not in k} == {
        k: v for k, v in want.items() if "wall" not in k}
