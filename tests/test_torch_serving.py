"""The serving front-end on the port against the JAX package, on the CPU.

Mirrors ``tests/test_serving.py`` case by case on the port's engines
(``device="cpu"``): cross-tenant coalesced waves bit-exact against solo
dispatch (fault-free and at sigma 0.15), the zero-lost, zero-duplicated
ticket invariant under a deterministic soak, typed admission and
deadline rejections, the per-tenant breaker's trip → half-open →
recovery, cancellation, the engines' re-entrancy guard, the structured
``FaultExhaustedError`` context and the worker mode; and
``tests/test_serve.py::test_pum_offload_matches_numpy_reference`` for
``PumServeOffload``.  Then ``benchmarks/serving_soak.py``'s scenarios at
``BENCH_serving.json``'s smoke configuration: the sigma-0 soaks and the
breaker scenario give the live reference's ``FrontendStats``, ticket
values, ``resolved_s`` and ``serving.*`` registry, ``==``, and the
file's numbers (integers ``==``, floats within a relative 1e-12); the
sigma 0.15 soak (flips from Philox, not ``jax.random``) keeps the soak's
invariants; and the worker thread, traced, resolves the same tickets to
the same values as the synchronous pump.
"""

import json
import math
import pathlib
import threading
import types

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro import obs as ref_obs
from repro.core.channel import SimdramChannel as RefChannel
from repro.core.fault import FaultModel as RefFaultModel
from repro.core.telemetry import REGISTRY as REF_REGISTRY
from repro.serving import AdmissionRejected as RefAdmissionRejected
from repro.serving import DeadlineExceeded as RefDeadlineExceeded
from repro.serving import ServingFrontend as RefFrontend
from repro.train.serve import PumServeOffload as RefOffload
from repro_torch import obs
from repro_torch.core.bank import Bank, BbopInstr, flatten_result
from repro_torch.core.channel import SimdramChannel
from repro_torch.core.chip import SimdramChip
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.core.isa import DispatchCancelled, SimdramDevice
from repro_torch.core.ops_library import get_op
from repro_torch.core.telemetry import REGISTRY
from repro_torch.serving import (AdmissionRejected, BreakerState,
                                 CircuitBreaker, DeadlineExceeded,
                                 ServingFrontend)
from repro_torch.train.serve import (PumServeOffload, PumStage,
                                     bbop_host_oracle)

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parents[1]
OPS2 = ["addition", "subtraction", "multiplication", "min", "max",
        "greater"]


def _channel(fault=None):
    return SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, fault=fault,
                          device=CPU)


def _requests(rng, n, n_bits=8, tenants=3):
    reqs = []
    for i in range(n):
        op = OPS2[int(rng.integers(0, len(OPS2)))]
        lanes = int(rng.integers(1, 24))
        a = rng.integers(0, 1 << n_bits, lanes)
        b = rng.integers(0, 1 << n_bits, lanes)
        reqs.append((f"tenant{i % tenants}", op, (a, b)))
    return reqs


def _exact(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- coalescing bit-exactness ---------------------------------------------

@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 12))
def test_coalesced_waves_bit_exact_vs_solo(seed, n):
    """Cross-tenant coalesced waves fan out per-tenant results identical
    to dispatching each request alone on a fresh engine."""
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, n)
    fe = ServingFrontend(_channel(), window=32)
    tickets = [fe.submit(t, op, ops_, 8) for t, op, ops_ in reqs]
    fe.drain()
    for ticket, (_, op, ops_) in zip(tickets, reqs):
        solo = SimdramDevice(backend="bank", device=CPU).dispatch(
            [BbopInstr(op, ops_, 8)])[0]
        _exact(ticket.result(0), solo)
        _exact(ticket.result(0), bbop_host_oracle(op, 8, ops_))


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10_000))
def test_coalesced_waves_bit_exact_under_faults(seed):
    """Same property at sigma 0.15 with one spare lane: detection, vote
    and retry heal every coalesced wave back to the exact answers."""
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, 6)
    fm = FaultModel(sigma=0.15, p_trials=20_000, spare_lanes=1,
                    seed=seed)
    fe = ServingFrontend(_channel(fault=fm), window=32)
    tickets = [fe.submit(t, op, ops_, 8) for t, op, ops_ in reqs]
    fe.drain()
    for ticket, (_, op, ops_) in zip(tickets, reqs):
        _exact(ticket.result(0), bbop_host_oracle(op, 8, ops_))


def test_multi_output_and_signed_fan_out(rng):
    """Tuple outputs and signed_out survive the slice fan-out."""
    a = rng.integers(0, 256, 9)
    b = rng.integers(1, 256, 9)
    fe = ServingFrontend(_channel(), window=8)
    td = fe.submit("t0", "division", (a, b), 8)
    ts = fe.submit("t1", "subtraction", (a, b), 8, signed_out=True)
    fe.drain()
    _exact(td.result(0), bbop_host_oracle("division", 8, (a, b)))
    _exact(ts.result(0),
           bbop_host_oracle("subtraction", 8, (a, b), signed_out=True))


# -- soak invariant --------------------------------------------------------

def test_soak_zero_lost_zero_duplicated_tickets():
    """Deterministic-seed soak under fault injection + deadline
    pressure: every admitted ticket resolves exactly once."""
    rng = np.random.default_rng(7)
    fm = FaultModel(sigma=0.15, p_trials=20_000, spare_lanes=1, seed=7)
    fe = ServingFrontend(_channel(fault=fm), max_queue_depth=24,
                         window=8, seed=7)
    tickets = []
    for round_ in range(6):
        for tenant, op, ops_ in _requests(rng, 8, tenants=4):
            deadline = (fe.now_s + float(rng.uniform(1e-7, 5e-3))
                        if rng.random() < 0.5 else None)
            try:
                tickets.append(
                    (fe.submit(tenant, op, ops_, 8, deadline_s=deadline,
                               priority=int(rng.integers(0, 3))),
                     op, ops_))
            except AdmissionRejected:
                pass
        fe.pump()
    fe.drain()
    st_ = fe.stats
    assert st_.admitted == len(tickets)
    ok = missed = 0
    for ticket, op, ops_ in tickets:
        assert ticket.done                       # zero lost
        try:
            _exact(ticket.result(0), bbop_host_oracle(op, 8, ops_))
            ok += 1
        except DeadlineExceeded:
            missed += 1
    assert ok + missed == len(tickets)
    assert st_.completed == ok and st_.deadline_missed == missed
    # double-resolution must raise (the duplicated-ticket guard)
    with pytest.raises(RuntimeError, match="resolved twice"):
        tickets[0][0]._settle(None, None)


# -- admission / deadlines -------------------------------------------------

def test_admission_rejected_carries_context(rng):
    fe = ServingFrontend(_channel(), max_queue_depth=2)
    a = rng.integers(0, 256, 4)
    fe.submit("a", "addition", (a, a), 8)
    fe.submit("a", "addition", (a, a), 8)
    with pytest.raises(AdmissionRejected) as ei:
        fe.submit("b", "addition", (a, a), 8)
    assert ei.value.queue_depth == 2 and ei.value.capacity == 2
    assert ei.value.tenant == "b"
    assert fe.stats.rejected == 1
    fe.drain()
    assert fe.stats.completed == 2               # admitted ones survive


def test_submit_validates_op_and_operands(rng):
    fe = ServingFrontend(_channel())
    a = rng.integers(0, 256, 4)
    with pytest.raises(KeyError):
        fe.submit("a", "no_such_op", (a, a), 8)
    with pytest.raises(ValueError, match="operands"):
        fe.submit("a", "addition", (a,), 8)


def test_expired_deadline_rejected_not_silently_late(rng):
    fe = ServingFrontend(_channel())
    a = rng.integers(0, 256, 4)
    t = fe.submit("late", "addition", (a, a), 8, deadline_s=-1.0)
    fe.drain()
    with pytest.raises(DeadlineExceeded) as ei:
        t.result(0)
    assert ei.value.tenant == "late" and ei.value.deadline_s == -1.0
    assert fe.stats.deadline_missed == 1 and fe.stats.completed == 0


# -- circuit breaker -------------------------------------------------------

def _dead_unit_frontend():
    """One dead subarray (seed 0, bank 0), zero redispatch budget: the
    first window that touches it exhausts, the retry path repacks
    around the blacklisted unit and succeeds."""
    fm = FaultModel(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                    max_redispatches=0, seed=0)
    ch = SimdramChannel(n_chips=1, n_banks=2, n_subarrays=2, fault=fm,
                        device=CPU)
    return ServingFrontend(ch, max_retries=0, breaker_threshold=1,
                           breaker_cooldown_s=1e-5)


def test_breaker_trips_to_host_oracle_and_recovers(rng):
    fe = _dead_unit_frontend()
    ops = ["addition", "subtraction", "min", "max"]   # 4 slots: one per
    a = rng.integers(0, 256, 8)                       # subarray, so the
    b = rng.integers(0, 256, 8)                       # dead one is hit
    first = [fe.submit("alice", op, (a, b), 8) for op in ops]
    fe.drain()
    br = fe.breakers["alice"]
    assert br.state == BreakerState.OPEN and br.trips == 1
    assert all(t.via_host for t in first)             # graceful, not lost
    assert fe.stats.breaker_trips == 1
    # while OPEN (cooldown not yet passed) requests shed to the oracle
    shed = fe.submit("alice", "addition", (a, b), 8)
    fe.drain()
    assert shed.via_host and br.state == BreakerState.OPEN
    # cooldown passes -> HALF_OPEN probe -> DRAM answers -> CLOSED
    fe._sleep(1e-4)
    probe = [fe.submit("alice", op, (a, b), 8) for op in ops]
    fe.drain()
    assert br.state == BreakerState.CLOSED and br.recoveries == 1
    assert not any(t.via_host for t in probe)
    assert fe.stats.breaker_recoveries == 1
    for t, op in zip(first + [shed] + probe, ops + ["addition"] + ops):
        _exact(t.result(0), bbop_host_oracle(op, 8, (a, b)))


def test_breaker_state_machine_unit():
    br = CircuitBreaker(threshold=2, cooldown_s=1.0)
    assert br.allow(0.0)
    assert not br.record_failure(0.0)                 # 1st: still CLOSED
    assert br.record_failure(0.0)                     # 2nd: trips
    assert br.state == BreakerState.OPEN
    assert not br.allow(0.5)                          # cooling down
    assert br.allow(1.5)                              # -> HALF_OPEN
    assert br.state == BreakerState.HALF_OPEN
    assert br.record_failure(1.5)                     # probe fails: re-OPEN
    assert br.state == BreakerState.OPEN and br.trips == 2
    assert br.allow(3.0)
    assert br.record_success(3.0)                     # probe ok: recovery
    assert br.state == BreakerState.CLOSED and br.recoveries == 1


def test_retry_with_backoff_recovers_without_tripping(rng):
    """With retry budget, the frontend repacks around the blacklisted
    dead unit on attempt 2 and never falls back to the host."""
    fm = FaultModel(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                    max_redispatches=0, seed=0)
    ch = SimdramChannel(n_chips=1, n_banks=2, n_subarrays=2, fault=fm,
                        device=CPU)
    fe = ServingFrontend(ch, max_retries=2, breaker_threshold=3, seed=5)
    ops = ["addition", "subtraction", "min", "max"]
    a = rng.integers(0, 256, 8)
    b = rng.integers(0, 256, 8)
    tickets = [fe.submit("bob", op, (a, b), 8) for op in ops]
    fe.drain()
    assert fe.stats.retries >= 1 and fe.stats.backoff_s > 0
    assert fe.stats.breaker_trips == 0
    assert not any(t.via_host for t in tickets)
    for t, op in zip(tickets, ops):
        _exact(t.result(0), bbop_host_oracle(op, 8, (a, b)))


# -- structured FaultExhaustedError ---------------------------------------

def test_fault_exhausted_error_carries_structured_context():
    fm = FaultModel(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                    max_redispatches=0, seed=0)
    ch = SimdramChannel(n_chips=1, n_banks=2, n_subarrays=2, fault=fm,
                        device=CPU)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 8)
    queue = [BbopInstr(op, (a, a), 8)
             for op in ("addition", "subtraction", "min", "max")]
    with pytest.raises(FaultExhaustedError) as ei:
        ch.dispatch(queue)
    err = ei.value
    assert err.tier == "channel"
    assert err.cause in ("redispatch_budget", "no_capacity")
    assert err.redispatches >= 1
    assert err.blacklist and all(len(u) == 3 for u in err.blacklist)
    ctx = err.context()
    assert ctx["tier"] == "channel"
    assert ctx["blacklisted_units"] == len(err.blacklist)
    assert ctx["capacity"] >= 0


def test_faulty_instruction_wider_than_a_row_raises_as_the_reference():
    """The fault layer's stuck-column pattern spans one physical row
    (65,536 columns): a fault-protected instruction whose replicated
    lanes are wider — as coalescing can make them — raises the same
    ``ValueError`` in both packages (carried in from the reference)."""
    from repro.core.bank import BbopInstr as RefBbopInstr
    a = np.arange(40_000, dtype=np.uint64) % np.uint64(256)
    errors = []
    for channel, model, instr, kw in (
            (RefChannel, RefFaultModel, RefBbopInstr, {}),
            (SimdramChannel, FaultModel, BbopInstr, {"device": CPU})):
        ch = channel(n_chips=1, n_banks=1, n_subarrays=1,
                     fault=model(p_flip=0.0, spare_lanes=1), **kw)
        with pytest.raises(ValueError) as ei:
            ch.dispatch([instr("addition", (a, a), 8)])
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert "could not broadcast" in errors[1]


# -- cancellation / re-entrancy -------------------------------------------

def test_dispatch_cancel_hook_aborts_between_rounds(rng):
    a = rng.integers(0, 256, 8)
    queue = [BbopInstr("addition", (a, a), 8)]
    for engine in (_channel(), SimdramDevice(backend="bitplane",
                                             device=CPU)):
        with pytest.raises(DispatchCancelled):
            engine.dispatch(queue, cancel=lambda: True)
    # cancel=None and cancel=False leave results identical
    eng = _channel()
    r1 = eng.dispatch(queue)
    r2 = _channel().dispatch(queue, cancel=lambda: False)
    _exact(flatten_result(r1[0]), flatten_result(r2[0]))


def test_concurrent_dispatch_raises_clear_error(rng):
    """A second dispatch on a busy engine raises RuntimeError instead of
    corrupting the in-flight double-buffered state."""
    a = rng.integers(0, 256, 8)
    queue = [BbopInstr("addition", (a, a), 8)]
    ch = _channel()
    errors = []

    def inner():
        try:
            ch.dispatch(queue)
        except RuntimeError as e:
            errors.append(str(e))

    orig = ch._dispatch_core

    def hooked(q, cancel=None):
        t = threading.Thread(target=inner)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        return orig(q, cancel=cancel)

    ch._dispatch_core = hooked
    try:
        ch.dispatch(queue)
    finally:
        ch._dispatch_core = orig
    assert len(errors) == 1
    assert "re-entered" in errors[0] and "SimdramChannel" in errors[0]
    # the engine is reusable afterwards
    _exact(flatten_result(ch.dispatch(queue)[0]),
           flatten_result(_channel().dispatch(queue)[0]))


def test_bank_guard_also_rejects_reentry(rng):
    a = rng.integers(0, 256, 8)
    bank = Bank(n_subarrays=2, device=CPU)
    with pytest.raises(RuntimeError, match="re-entered"):
        with bank._guard:
            bank.dispatch([BbopInstr("addition", (a, a), 8)])


# -- background worker -----------------------------------------------------

def test_background_worker_resolves_tickets(rng):
    fe = ServingFrontend(_channel(), window=8)
    fe.start()
    try:
        reqs = _requests(rng, 6)
        tickets = [fe.submit(t, op, ops_, 8) for t, op, ops_ in reqs]
        for ticket, (_, op, ops_) in zip(tickets, reqs):
            _exact(ticket.result(timeout=30.0),
                   bbop_host_oracle(op, 8, ops_))
    finally:
        fe.stop()
    assert fe.stats.completed == 6


def test_priority_orders_the_window(rng):
    """With window=1, the high-priority late submission pumps first."""
    fe = ServingFrontend(_channel(), window=1)
    a = rng.integers(0, 256, 4)
    lo = fe.submit("lo", "addition", (a, a), 8, priority=0)
    hi = fe.submit("hi", "addition", (a, a), 8, priority=5)
    fe.pump()
    assert hi.done and not lo.done
    fe.drain()
    assert lo.done


def test_default_engine_is_a_channel_on_the_card():
    """``ServingFrontend()`` builds its channel on ``"cuda"``, with no
    fall-back to the CPU (without a card it raises)."""
    import torch
    if torch.cuda.is_available():
        fe = ServingFrontend()
        assert fe.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            ServingFrontend()


# -- the logit offload (tests/test_serve.py) -------------------------------

def test_pum_offload_matches_numpy_reference():
    """The chip-dispatched quantize → stages → dequantize pipeline is
    bit-exact against its numpy oracle and the reference's offload, for
    the identity clamp and for a semantic relu stage, and argmax
    (greedy decoding) is preserved by the default stages."""
    from repro.core.chip import SimdramChip as RefChip

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 96)).astype(np.float32)
    off = PumServeOffload(chip=SimdramChip(n_banks=4, n_subarrays=2,
                                           device=CPU))
    got = off(logits)
    np.testing.assert_array_equal(got, off.reference(logits))
    np.testing.assert_array_equal(
        got, RefOffload(chip=RefChip(n_banks=4, n_subarrays=2))(logits))
    np.testing.assert_array_equal(np.argmax(got, -1),
                                  np.argmax(logits, -1))
    st_ = off.chip.stats
    assert st_.bbops == 4 * len(off.stages)
    assert st_.bank_programs.min() >= 1
    assert st_.transpositions_skipped > 0      # Ref-linked stage chains

    tie = np.zeros((1, 96), np.float32)
    tie[0, 94], tie[0, 95] = 10.0, 10.001
    np.testing.assert_array_equal(off(tie), tie)
    assert int(np.argmax(off(tie), -1)[0]) == 95

    relu = PumServeOffload(chip=SimdramChip(n_banks=2, n_subarrays=2,
                                            device=CPU),
                           stages=(PumStage("relu"),))
    x = rng.normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_array_equal(relu(x), relu.reference(x))
    with pytest.raises(ValueError):
        PumServeOffload(chip=off.chip, stages=(PumStage("division", 3),))


# -- benchmarks/serving_soak.py's scenarios, both packages ------------------

OPS_POOL = ("addition", "subtraction", "multiplication", "min", "max",
            "relu", "bitcount", "division")
TENANTS = ("alice", "bob", "carol")
GENEROUS_S = 10.0
TIGHT_S = 1e-7
SMOKE = {"rounds": 3, "lanes": 32, "p_trials": 20_000}
BENCH_REL_TOL = 1e-12

REF = types.SimpleNamespace(
    channel=RefChannel, fault=RefFaultModel, frontend=RefFrontend,
    rejected=RefAdmissionRejected, registry=REF_REGISTRY, kw={})
PORT = types.SimpleNamespace(
    channel=SimdramChannel, fault=FaultModel, frontend=ServingFrontend,
    rejected=AdmissionRejected, registry=REGISTRY, kw={"device": CPU})


def _traffic(rng, n, lanes, widths=(8, 16)):
    """``serving_soak._traffic``: n deterministic (op, n_bits,
    operands) requests."""
    out = []
    for _ in range(n):
        op = OPS_POOL[int(rng.integers(len(OPS_POOL)))]
        n_bits = int(widths[int(rng.integers(len(widths)))])
        operands = tuple(
            np.asarray(rng.integers(0, 1 << min(n_bits, 16), size=lanes),
                       np.int64)
            for _ in range(get_op(op, n_bits).n_operands))
        out.append((op, n_bits, operands))
    return out


def _settle(fe, tickets, worker):
    """Resolve a round's tickets: ``drain()``, or the worker thread
    started and stopped around them."""
    if not worker:
        fe.drain()
        return
    fe.start()
    try:
        for t, *_ in tickets:
            try:
                t.result(timeout=120)
            except DeadlineExceeded:
                pass
    finally:
        fe.stop()


def _soak(pkg, load, sigma, rounds, lanes, p_trials, worker=False):
    """``serving_soak._soak_scenario`` on ``pkg``: returns the frontend,
    the tickets and the report entry."""
    pkg.registry.reset()
    fault = None
    if sigma > 0.0:
        fault = pkg.fault(sigma=sigma, p_trials=p_trials, spare_lanes=1,
                          stuck_lane_rate=0.002, seed=21)
    engine = pkg.channel(n_chips=2, n_banks=2, n_subarrays=2, fault=fault,
                         **pkg.kw)
    fe = pkg.frontend(engine, max_queue_depth=max(1, (3 * load) // 4),
                      window=load, max_retries=2, seed=0)
    rng = np.random.default_rng(0)
    tickets = []
    for _ in range(rounds):
        round_tickets = []
        for i, (op, n_bits, operands) in enumerate(
                _traffic(rng, load, lanes)):
            deadline = fe.now_s + (TIGHT_S if i % 4 == 3 else GENEROUS_S)
            try:
                t = fe.submit(TENANTS[i % len(TENANTS)], op, operands,
                              n_bits, deadline_s=deadline,
                              priority=1 if i % 5 == 0 else 0)
            except pkg.rejected:
                continue
            round_tickets.append((t, op, n_bits, operands))
        _settle(fe, round_tickets, worker)
        tickets += round_tickets
    hist = pkg.registry.histogram("serving.latency_modeled_s")
    entry = {"goodput_rps": fe.stats.completed / max(fe.now_s, 1e-12),
             "p50_latency_s": hist.percentile(50),
             "p99_latency_s": hist.percentile(99),
             "modeled_duration_s": fe.now_s, **fe.stats.as_dict()}
    return fe, tickets, entry


def _check_invariants(fe, tickets):
    """Zero lost, zero duplicated (``_settle`` raises on a second
    resolution), every completed ticket ``==`` the host oracle, and the
    ticket accounting closes."""
    ok = missed = 0
    for t, op, n_bits, operands in tickets:
        assert t.done
        try:
            got = t.result(timeout=0)
        except DeadlineExceeded:
            missed += 1
            continue
        _exact(got, bbop_host_oracle(op, n_bits, operands))
        ok += 1
    s = fe.stats
    assert s.admitted == len(tickets)
    assert (ok, missed) == (s.completed, s.deadline_missed)
    assert s.completed + s.deadline_missed == s.admitted


def _ticket_view(tickets):
    """Each ticket's value (or its error's type) and ``resolved_s``."""
    out = []
    for t, *_ in tickets:
        try:
            v = t.result(timeout=0)
            v = [np.asarray(x).tolist() for x in
                 (v if isinstance(v, tuple) else (v,))]
        except (DeadlineExceeded, RefDeadlineExceeded) as e:
            v = (type(e).__name__, e.where)
        out.append((t.seq, t.tenant, t.via_host, v, t.resolved_s))
    return out


def _assert_matches_record(got: dict, want: dict):
    """Integer fields ``==`` the committed record, floats within a
    relative 1e-12 (the record was summed in another order)."""
    for key, w in want.items():
        if key not in got:
            continue
        g = got[key]
        if isinstance(w, bool) or isinstance(w, int):
            assert g == w, (key, g, w)
        else:
            assert math.isclose(g, w, rel_tol=BENCH_REL_TOL,
                                abs_tol=0.0), (key, g, w)


def _record():
    return json.loads((REPO / "BENCH_serving.json").read_text())


@pytest.mark.parametrize("load", [4, 12])
def test_soak_sigma0_equals_the_reference_and_the_record(load):
    """``serving_soak`` at sigma 0 (the smoke configuration): the port's
    frontend stats, every ticket's value and ``resolved_s``, and the
    ``serving.*`` registry ``==`` a live reference run; the report entry
    matches ``BENCH_serving.json``."""
    fe_r, t_r, e_r = _soak(REF, load, 0.0, **SMOKE)
    reg_r = REF_REGISTRY.snapshot("serving.")
    fe_p, t_p, e_p = _soak(PORT, load, 0.0, **SMOKE)
    _check_invariants(fe_p, t_p)
    assert fe_p.stats.as_dict() == fe_r.stats.as_dict()
    assert _ticket_view(t_p) == _ticket_view(t_r)
    assert REGISTRY.snapshot("serving.") == reg_r
    assert e_p == e_r
    _assert_matches_record(e_p, _record()["sweep"][
        f"load={load}/sigma=0.00"])


def _breaker(pkg):
    """``serving_soak._breaker_scenario`` on ``pkg``: trip → shed →
    half-open → recover."""
    pkg.registry.reset()
    model = pkg.fault(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                      max_redispatches=0, seed=0)
    engine = pkg.channel(n_chips=1, n_banks=2, n_subarrays=2, fault=model,
                         **pkg.kw)
    fe = pkg.frontend(engine, max_retries=0, breaker_threshold=1,
                      breaker_cooldown_s=1e-5, window=8, seed=0)
    rng = np.random.default_rng(7)
    windows = []
    for w in range(3):
        if w == 2:
            fe.now_s += 10 * fe.breaker_cooldown_s   # cooldown elapses
        out = []
        for op in ("addition", "subtraction", "min", "max"):
            a = np.asarray(rng.integers(0, 256, 64), np.int64)
            b = np.asarray(rng.integers(0, 256, 64), np.int64)
            out.append((fe.submit("alice", op, (a, b), 8), op, 8, (a, b)))
        fe.drain()
        windows.append(out)
    return fe, windows


def test_breaker_scenario_equals_the_reference_and_the_record():
    fe_r, w_r = _breaker(REF)
    reg_r = REF_REGISTRY.snapshot("serving.")
    fe_p, w_p = _breaker(PORT)
    tripped, shed, probe = w_p
    _check_invariants(fe_p, tripped + shed + probe)
    assert all(t.via_host for t, *_ in tripped + shed)
    assert not any(t.via_host for t, *_ in probe)
    s = fe_p.stats
    assert s.as_dict() == fe_r.stats.as_dict()
    assert _ticket_view(sum(w_p, [])) == _ticket_view(sum(w_r, []))
    reg = REGISTRY.snapshot("serving.")
    assert reg == reg_r
    rec = _record()
    for key in ("breaker_trips", "breaker_recoveries", "host_fallbacks",
                "completed"):
        assert getattr(s, key) == rec["breaker"][key], key
    _assert_matches_record(reg, rec["registry"])
    assert set(reg) == set(rec["registry"])


def test_soak_under_faults_keeps_the_invariants():
    """sigma 0.15 with stuck lanes (the soak's faulty scenario at load
    12): flips come from Philox here, so the run is held to the soak's
    invariants, not to the reference's numbers."""
    fe, tickets, entry = _soak(PORT, 12, 0.15, **SMOKE)
    _check_invariants(fe, tickets)
    assert fe.stats.admitted > 0 and fe.stats.completed > 0
    assert entry["goodput_rps"] > 0


def test_worker_thread_traced_resolves_as_the_pump():
    """The same traffic through ``start()``/``stop()`` on the worker
    thread, with a tracer enabled (the span stack is a module global),
    resolves the same tickets to the same values and times as the
    synchronous pump; every span closes and each pump is a root."""
    fe_s, t_s, e_s = _soak(PORT, 4, 0.0, **SMOKE)
    with obs.enabled(max_dispatches=256) as tr:
        fe_w, t_w, e_w = _soak(PORT, 4, 0.0, worker=True, **SMOKE)
        assert tr.depth == 0
        pumps = [r for r in tr.roots if r.name != "pum.executor"]
    _check_invariants(fe_w, t_w)
    assert _ticket_view(t_w) == _ticket_view(t_s)
    assert e_w == e_s
    assert {r.name for r in pumps} == {"serving.pump"}
    assert sum(len(r.find("serving.dispatch")) for r in pumps) == (
        fe_w.stats.waves)
    # the reference under its own tracer gives the same span names
    with ref_obs.enabled(max_dispatches=256) as rtr:
        _soak(REF, 4, 0.0, **SMOKE)
    assert ([s.name for r in tr.roots for s in r.walk()]
            == [s.name for r in rtr.roots for s in r.walk()])
