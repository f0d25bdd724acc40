"""Async multi-tenant serving front-end over the SIMDRAM ladder.

Counterpart of :mod:`repro.serving.frontend`, over the port's engines
(whose rounds replay on K5, or on K6 with a fault model).  The engines (bank / chip / channel) execute ONE synchronous caller's
queue at a time — by design: the fused dispatchers keep double-buffered
pack state on the engine while a queue drains, and
:class:`~repro_torch.core.isa.DispatchGuard` rejects concurrent entry.  This
module is the layer that turns that single-caller engine into a shared
service, the way the end-to-end SIMDRAM framework paper frames in-DRAM
compute as a transparently managed resource behind the memory
controller:

  - **Admission control** — a bounded queue; a full queue raises a
    typed :class:`AdmissionRejected` (with depth/capacity context) so
    callers back off instead of piling up unbounded work.
  - **Batching window** — each :meth:`ServingFrontend.pump` takes up to
    ``window`` admitted requests (highest priority first, then earliest
    deadline), coalesces compatible ``(op, n_bits, signed_out)``
    requests across tenants into ONE shared :class:`BbopInstr` each by
    concatenating their lanes, drains all groups through a single
    engine dispatch (heterogeneous wave fusion does the rest), and
    fans results back out to each ticket by lane slice — bit-exactly
    equal to dispatching each request alone.
  - **Deadlines** — absolute points on the *modeled* DRAM clock
    (:attr:`ServingFrontend.now_s`).  Expired requests are rejected
    with :class:`DeadlineExceeded` before dispatch; a wave whose every
    deadline passes mid-replay is abandoned at a super-round boundary
    through the engines' ``cancel`` hook; work that finishes past its
    deadline is rejected too, never silently completed late.
  - **Retry with backoff** — a dispatch that dies with
    :class:`~repro_torch.core.fault.FaultExhaustedError` is retried up to
    ``max_retries`` times with exponential backoff × seeded jitter
    (the engine blacklists offenders between attempts, so retries
    genuinely repack around them).
  - **Circuit breaker + graceful degradation** — per-tenant
    CLOSED → OPEN → HALF_OPEN breaker.  Repeated terminal failures trip
    a tenant to the host-oracle fallback path
    (:func:`repro_torch.train.serve.bbop_host_oracle` — the same oracle
    ``PumServeOffload`` answers from), which stays bit-exact; after a
    modeled cooldown the breaker half-opens and one probe wave decides
    whether DRAM service resumes.

Everything is deterministic under a fixed seed: the clock is the
engines' modeled DRAM seconds (plus explicit backoff/cooldown waits),
never wall time, so a soak run replays identically.

Thread model: :meth:`submit` is safe from any thread;
:meth:`pump`/:meth:`drain` execute dispatches synchronously on the
calling thread (the deterministic mode benchmarks and tests use), and
:meth:`start`/:meth:`stop` run the same pump loop on a background
worker so submitters only ever block on their own
:meth:`Ticket.result`.  The worker's launches, copies and events go to
the card's default stream, the one the main thread's copies use (the
tracer is a module global, as in the reference: one pump at a time
writes to its span stack).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.bank import BbopInstr, cached_table
from ..core.fault import FaultExhaustedError
from ..core.isa import DispatchCancelled
from ..core.telemetry import REGISTRY, active_tracer, spec_as_dict
from ..train.serve import bbop_host_oracle


class AdmissionRejected(RuntimeError):
    """The bounded admission queue is full: back off and resubmit.

    Carries the rejection context so callers (and incident records) see
    the pressure, not just the refusal."""

    def __init__(self, tenant: str, queue_depth: int, capacity: int):
        super().__init__(
            f"admission queue full ({queue_depth}/{capacity} pending): "
            f"request from tenant {tenant!r} rejected — back off and "
            f"resubmit")
        self.tenant = tenant
        self.queue_depth = int(queue_depth)
        self.capacity = int(capacity)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or during) execution; the
    work was cancelled or its late result discarded."""

    def __init__(self, tenant: str, deadline_s: float, now_s: float,
                 where: str):
        super().__init__(
            f"deadline {deadline_s:.6g}s passed (modeled clock now "
            f"{now_s:.6g}s) {where}: request from tenant {tenant!r} "
            f"cancelled")
        self.tenant = tenant
        self.deadline_s = float(deadline_s)
        self.now_s = float(now_s)
        self.where = where


class BreakerState:
    CLOSED = "closed"        # normal service: requests dispatch to DRAM
    OPEN = "open"            # tripped: requests answer from host oracle
    HALF_OPEN = "half_open"  # cooldown over: one probe wave decides


class CircuitBreaker:
    """Per-tenant failure breaker (modeled-clock cooldown).

    ``threshold`` consecutive terminal dispatch failures trip
    CLOSED → OPEN; while OPEN the tenant's requests are shed to the
    host oracle.  ``allow()`` called after ``cooldown_s`` modeled
    seconds transitions OPEN → HALF_OPEN and admits one probe; the
    probe's wave succeeding closes the breaker, failing re-opens it
    (cooldown re-arms).
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 1e-3):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = BreakerState.CLOSED
        self.failures = 0          # consecutive terminal failures
        self.opened_at_s = 0.0
        self.trips = 0
        self.recoveries = 0

    def allow(self, now_s: float) -> bool:
        """May this tenant's request go to DRAM right now?"""
        if self.state == BreakerState.CLOSED:
            return True
        if self.state == BreakerState.OPEN:
            if now_s - self.opened_at_s >= self.cooldown_s:
                self.state = BreakerState.HALF_OPEN
                return True
            return False
        return True              # HALF_OPEN: probe in flight

    def record_success(self, now_s: float) -> bool:
        """A wave carrying this tenant completed; True if this closed a
        half-open breaker (a recovery)."""
        self.failures = 0
        if self.state == BreakerState.HALF_OPEN:
            self.state = BreakerState.CLOSED
            self.recoveries += 1
            return True
        return False

    def record_failure(self, now_s: float) -> bool:
        """A wave carrying this tenant terminally failed; True if this
        tripped (or re-tripped) the breaker OPEN."""
        self.failures += 1
        if self.state == BreakerState.HALF_OPEN or (
                self.state == BreakerState.CLOSED
                and self.failures >= self.threshold):
            self.state = BreakerState.OPEN
            self.opened_at_s = now_s
            self.trips += 1
            return True
        return False


class Ticket:
    """Future-style completion handle for one submitted request.

    Exactly-once resolution is enforced: a second resolve/reject raises
    (the zero-duplicated-ticket invariant the soak benchmark gates).
    """

    __slots__ = ("seq", "tenant", "op", "n_bits", "signed_out", "priority",
                 "deadline_s", "submitted_s", "resolved_s", "_event",
                 "_value", "_error", "_done", "via_host", "_lock")

    def __init__(self, seq: int, tenant: str, op: str, n_bits: int,
                 signed_out: bool, priority: int, deadline_s: float,
                 submitted_s: float):
        self.seq = seq
        self.tenant = tenant
        self.op = op
        self.n_bits = n_bits
        self.signed_out = signed_out
        self.priority = priority
        self.deadline_s = deadline_s
        self.submitted_s = submitted_s     # modeled clock at admission
        self.resolved_s = math.nan         # modeled clock at resolution
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = False
        self.via_host = False    # answered by the host-oracle fallback?
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None):
        """Block (wall-clock) until resolved; returns the op's outputs
        (int64 array, tuple for multi-output ops) or raises the typed
        failure (:class:`DeadlineExceeded`, …).  In synchronous mode
        call :meth:`ServingFrontend.pump`/``drain`` first — nothing
        resolves tickets while no worker runs."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.seq} (tenant {self.tenant!r}) unresolved "
                f"after {timeout}s — is the frontend pumping?")
        if self._error is not None:
            raise self._error
        return self._value

    def _settle(self, value, error: Optional[BaseException]) -> None:
        with self._lock:
            if self._done:
                raise RuntimeError(
                    f"ticket {self.seq} (tenant {self.tenant!r}) resolved "
                    f"twice — fan-out bug")
            self._value = value
            self._error = error
            self._done = True
        self._event.set()


@dataclass
class _Request:
    """A submitted, admitted request waiting in the window queue."""
    ticket: Ticket
    operands: Tuple[np.ndarray, ...]
    attempts: int = 0


@dataclass
class FrontendStats:
    """Serving-layer counters (the engine's own Stats tiers sit below).

    ``admitted == completed + deadline_missed`` once drained — the
    zero-lost-ticket invariant; ``completed`` includes host-oracle
    answers (``host_fallbacks`` of them)."""

    submitted: int = 0           # submit() calls, incl. rejected
    admitted: int = 0            # tickets issued
    rejected: int = 0            # AdmissionRejected at submit
    completed: int = 0           # tickets resolved with a value
    deadline_missed: int = 0     # tickets rejected DeadlineExceeded
    host_fallbacks: int = 0      # completions answered by the oracle
    waves: int = 0               # engine dispatches that succeeded
    coalesced_instrs: int = 0    # BbopInstrs across those waves
    cancelled_waves: int = 0     # dispatches abandoned via cancel hook
    dispatch_failures: int = 0   # FaultExhaustedError from the engine
    retries: int = 0             # re-dispatch attempts after backoff
    backoff_s: float = 0.0       # modeled seconds slept in backoff
    breaker_trips: int = 0
    breaker_recoveries: int = 0

    _FIELD_SPEC = (
        ("submitted", "int"),
        ("admitted", "int"),
        ("rejected", "int"),
        ("completed", "int"),
        ("deadline_missed", "int"),
        ("host_fallbacks", "int"),
        ("waves", "int"),
        ("coalesced_instrs", "int"),
        ("cancelled_waves", "int"),
        ("dispatch_failures", "int"),
        ("retries", "int"),
        ("backoff_s", "float"),
        ("breaker_trips", "int"),
        ("breaker_recoveries", "int"),
    )

    def as_dict(self) -> Dict[str, object]:
        return spec_as_dict(self)


class ServingFrontend:
    """Multi-tenant admission/batching/degradation layer over one engine.

    Args:
        engine: anything with ``dispatch(queue, cancel=...)`` and a
            ``stats.total_latency_s`` modeled clock — normally a
            :class:`~repro_torch.core.channel.SimdramChannel` (the
            default, created here on ``"cuda"``), but the chip and bank
            engines work too; the engine decides the device.
        max_queue_depth: admission bound; :meth:`submit` raises
            :class:`AdmissionRejected` beyond it.
        window: max requests coalesced into one pump's shared wave.
        max_retries: re-dispatches after ``FaultExhaustedError`` before
            the wave is declared terminally failed.
        backoff_s / backoff_mult / jitter: retry backoff — attempt *k*
            sleeps ``backoff_s * backoff_mult**(k-1) * (1 + jitter*u)``
            modeled seconds, ``u`` drawn from the seeded rng.
        breaker_threshold / breaker_cooldown_s: per-tenant circuit
            breaker configuration (see :class:`CircuitBreaker`).
        seed: jitter rng seed (determinism under test).
    """

    def __init__(self, engine=None, *, max_queue_depth: int = 256,
                 window: int = 16, max_retries: int = 2,
                 backoff_s: float = 1e-4, backoff_mult: float = 2.0,
                 jitter: float = 0.25, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1e-3, seed: int = 0):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        if engine is None:
            from ..core.channel import SimdramChannel
            engine = SimdramChannel()
        self.engine = engine
        self.style = getattr(engine, "style", "mig")
        self.max_queue_depth = max_queue_depth
        self.window = window
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.jitter = jitter
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._rng = np.random.default_rng(seed)
        self.stats = FrontendStats()
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.now_s = 0.0                       # modeled DRAM clock
        self._eng_base = self._modeled_total()
        self._seq = 0
        self._pending: List[_Request] = []
        self._lock = threading.Lock()          # queue + clock + breakers
        self._have_work = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        self._stop = False

    # -- submission --------------------------------------------------------
    def submit(self, tenant: str, op: str, operands: Sequence, n_bits: int,
               *, deadline_s: Optional[float] = None, priority: int = 0,
               signed_out: bool = False) -> Ticket:
        """Admit one bbop request from ``tenant``; returns its
        :class:`Ticket` or raises :class:`AdmissionRejected` /
        ``KeyError`` (unknown op) / ``ValueError`` (operand mismatch).

        ``deadline_s`` is an ABSOLUTE modeled-clock point (compare
        :attr:`now_s`); ``None`` means no deadline.  Operands are flat
        integer arrays (one element per SIMD lane)."""
        spec, _, _ = cached_table(op, n_bits, self.style)
        if len(operands) != spec.n_operands:
            raise ValueError(
                f"{op} takes {spec.n_operands} operands, got "
                f"{len(operands)}")
        arrs = tuple(np.asarray(o).astype(np.int64).reshape(-1)
                     for o in operands)
        if len({a.shape[-1] for a in arrs}) > 1:
            raise ValueError("operand lengths differ")
        dl = math.inf if deadline_s is None else float(deadline_s)
        with self._lock:
            self.stats.submitted += 1
            if len(self._pending) >= self.max_queue_depth:
                self.stats.rejected += 1
                REGISTRY.counter("serving.rejected").inc()
                tr = active_tracer()
                if tr is not None:
                    tr.incident("admission_rejected", tenant=tenant,
                                queue_depth=len(self._pending),
                                capacity=self.max_queue_depth)
                raise AdmissionRejected(tenant, len(self._pending),
                                        self.max_queue_depth)
            self._seq += 1
            ticket = Ticket(self._seq, tenant, op, n_bits, signed_out,
                            priority, dl, self.now_s)
            self._pending.append(_Request(ticket, arrs))
            self.stats.admitted += 1
            REGISTRY.gauge("serving.queue_depth").set(len(self._pending))
            self._have_work.notify()
        return ticket

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- the pump ----------------------------------------------------------
    def pump(self) -> int:
        """Process one batching window synchronously; returns how many
        tickets were resolved (zero when the queue was empty)."""
        with self._lock:
            self._pending.sort(key=lambda r: (-r.ticket.priority,
                                              r.ticket.deadline_s,
                                              r.ticket.seq))
            batch = self._pending[:self.window]
            del self._pending[:self.window]
            REGISTRY.gauge("serving.queue_depth").set(len(self._pending))
        if not batch:
            return 0
        tr = active_tracer()
        root = (tr.begin("serving.pump", cat="serve", requests=len(batch),
                         tenants=len({r.ticket.tenant for r in batch}))
                if tr is not None else None)
        try:
            resolved = 0
            dispatchable: List[_Request] = []
            for r in batch:
                if r.ticket.deadline_s < self.now_s:
                    self._reject_deadline(r, "before dispatch")
                    resolved += 1
                elif not self._breaker(r.ticket.tenant).allow(self.now_s):
                    self._resolve_host(r)      # shed: breaker is OPEN
                    resolved += 1
                else:
                    dispatchable.append(r)
            resolved += self._dispatch_window(dispatchable)
            return resolved
        finally:
            if root is not None:
                tr.end(root)

    def drain(self) -> int:
        """Pump until the admission queue is empty; returns tickets
        resolved."""
        total = 0
        while True:
            n = self.pump()
            if n == 0 and not self.queue_depth:
                return total
            total += n

    # -- background worker -------------------------------------------------
    def start(self) -> None:
        """Run the pump loop on a background thread (true async mode:
        submitters block only on their own tickets)."""
        if self._worker is not None:
            raise RuntimeError("frontend worker already running")
        self._stop = False
        self._worker = threading.Thread(
            target=self._run, name="serving-frontend", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the worker after it finishes the in-flight window."""
        if self._worker is None:
            return
        with self._lock:
            self._stop = True
            self._have_work.notify()
        self._worker.join()
        self._worker = None

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._have_work.wait(0.05)
                if self._stop and not self._pending:
                    return
            self.pump()

    # -- internals ---------------------------------------------------------
    def _modeled_total(self) -> float:
        stats = getattr(self.engine, "stats", None)
        return float(getattr(stats, "total_latency_s", 0.0))

    def _advance_clock(self) -> None:
        total = self._modeled_total()
        self.now_s += total - self._eng_base
        self._eng_base = total

    def _sleep(self, seconds: float) -> None:
        self.now_s += seconds
        self.stats.backoff_s += seconds

    def _backoff(self, attempt: int) -> float:
        u = float(self._rng.random())
        return (self.backoff_s * self.backoff_mult ** (attempt - 1)
                * (1.0 + self.jitter * u))

    def _breaker(self, tenant: str) -> CircuitBreaker:
        br = self.breakers.get(tenant)
        if br is None:
            br = self.breakers[tenant] = CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown_s)
        return br

    def _finish(self, r: _Request, value,
                error: Optional[BaseException]) -> None:
        """Resolve one ticket exactly once, stamping its modeled
        completion time and the end-to-end latency histogram."""
        r.ticket.resolved_s = self.now_s
        REGISTRY.histogram("serving.latency_modeled_s").observe(
            self.now_s - r.ticket.submitted_s)
        r.ticket._settle(value, error)

    def _reject_deadline(self, r: _Request, where: str) -> None:
        self.stats.deadline_missed += 1
        REGISTRY.counter("serving.deadline_missed").inc()
        tr = active_tracer()
        if tr is not None:
            tr.incident("deadline_missed", tenant=r.ticket.tenant,
                        seq=r.ticket.seq, deadline_s=r.ticket.deadline_s,
                        now_s=self.now_s, where=where)
        self._finish(r, None, DeadlineExceeded(
            r.ticket.tenant, r.ticket.deadline_s, self.now_s, where))

    def _resolve_host(self, r: _Request) -> None:
        """Answer one request from the host oracle (bit-exact graceful
        degradation — no DRAM time is charged)."""
        value = bbop_host_oracle(r.ticket.op, r.ticket.n_bits, r.operands,
                                 signed_out=r.ticket.signed_out)
        r.ticket.via_host = True
        self.stats.host_fallbacks += 1
        self.stats.completed += 1
        REGISTRY.counter("serving.host_fallbacks").inc()
        self._finish(r, value, None)

    def _coalesce(self, reqs: Sequence[_Request]):
        """Group ``reqs`` by (op, n_bits, signed_out) and concatenate
        each group's lanes into ONE shared BbopInstr.  Returns the
        queue plus per-request ``(req, instr_index, lo, hi)`` fan-out
        slices."""
        groups: Dict[Tuple[str, int, bool], List[_Request]] = {}
        for r in reqs:
            key = (r.ticket.op, r.ticket.n_bits, r.ticket.signed_out)
            groups.setdefault(key, []).append(r)
        queue: List[BbopInstr] = []
        slices: List[Tuple[_Request, int, int, int]] = []
        for (op, n_bits, signed_out), members in groups.items():
            n_ops = len(members[0].operands)
            operands = tuple(
                np.concatenate([m.operands[j] for m in members], axis=-1)
                for j in range(n_ops))
            qi = len(queue)
            queue.append(BbopInstr(op, operands, n_bits,
                                   signed_out=signed_out))
            lo = 0
            for m in members:
                hi = lo + m.operands[0].shape[-1]
                slices.append((m, qi, lo, hi))
                lo = hi
        return queue, slices

    def _dispatch_window(self, reqs: List[_Request]) -> int:
        """Dispatch one coalesced window with retry/backoff; resolve
        every ticket exactly once.  Returns tickets resolved."""
        if not reqs:
            return 0
        tr = active_tracer()
        resolved = 0
        attempt = 0
        while True:
            live: List[_Request] = []
            for r in reqs:
                if r.ticket.deadline_s < self.now_s:
                    self._reject_deadline(r, "after backoff")
                    resolved += 1
                else:
                    live.append(r)
            reqs = live
            if not reqs:
                return resolved
            queue, slices = self._coalesce(reqs)
            max_deadline = max(r.ticket.deadline_s for r in reqs)
            clock0, base0 = self.now_s, self._modeled_total()
            cancel = None
            if not math.isinf(max_deadline):
                cancel = (lambda: clock0 + (self._modeled_total() - base0)
                          > max_deadline)
            try:
                if tr is not None:
                    with tr.span("serving.dispatch", cat="serve",
                                 instrs=len(queue), requests=len(reqs),
                                 attempt=attempt):
                        results = self.engine.dispatch(queue, cancel=cancel)
                else:
                    results = self.engine.dispatch(queue, cancel=cancel)
            except DispatchCancelled:
                self._advance_clock()
                self.stats.cancelled_waves += 1
                REGISTRY.counter("serving.cancelled_waves").inc()
                for r in reqs:
                    self._reject_deadline(r, "mid-dispatch (cancelled)")
                return resolved + len(reqs)
            except FaultExhaustedError as e:
                self._advance_clock()
                attempt += 1
                self.stats.dispatch_failures += 1
                if tr is not None:
                    tr.incident("serving_dispatch_failed", attempt=attempt,
                                requests=len(reqs), **e.context())
                if attempt <= self.max_retries:
                    self.stats.retries += 1
                    self._sleep(self._backoff(attempt))
                    continue
                return resolved + self._fail_window(reqs)
            self._advance_clock()
            self.stats.waves += 1
            self.stats.coalesced_instrs += len(queue)
            for r, qi, lo, hi in slices:
                out = results[qi]
                value = (tuple(np.asarray(o)[..., lo:hi] for o in out)
                         if isinstance(out, tuple)
                         else np.asarray(out)[..., lo:hi])
                if r.ticket.deadline_s < self.now_s:
                    self._reject_deadline(r, "on completion (late)")
                else:
                    self.stats.completed += 1
                    self._finish(r, value, None)
                resolved += 1
            for tenant in {r.ticket.tenant for r in reqs}:
                if self._breaker(tenant).record_success(self.now_s):
                    self.stats.breaker_recoveries += 1
                    REGISTRY.counter("serving.breaker_recoveries").inc()
                    if tr is not None:
                        tr.incident("breaker_closed", tenant=tenant,
                                    now_s=self.now_s)
            self._publish_breaker_gauge()
            return resolved

    def _fail_window(self, reqs: List[_Request]) -> int:
        """Terminal wave failure: mark every tenant's breaker, answer
        every ticket from the host oracle (still bit-exact)."""
        tr = active_tracer()
        for tenant in {r.ticket.tenant for r in reqs}:
            if self._breaker(tenant).record_failure(self.now_s):
                self.stats.breaker_trips += 1
                REGISTRY.counter("serving.breaker_trips").inc()
                if tr is not None:
                    tr.incident("breaker_open", tenant=tenant,
                                now_s=self.now_s,
                                failures=self._breaker(tenant).failures)
        self._publish_breaker_gauge()
        for r in reqs:
            self._resolve_host(r)
        return len(reqs)

    def _publish_breaker_gauge(self) -> None:
        REGISTRY.gauge("serving.breakers_open").set(sum(
            1 for b in self.breakers.values()
            if b.state != BreakerState.CLOSED))
