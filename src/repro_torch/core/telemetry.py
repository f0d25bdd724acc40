"""Ladder-wide telemetry: dual-clock spans, metrics, flight recorder, exporters.

Counterpart of :mod:`repro.core.telemetry`.  Every stage of a dispatch —
queue validation, wave/round/super-round packing, ``TABLE_CACHE``
lookup, replay, fault handling, host<->chip transfer, unpack,
serve-tier fallback — can open a *span*.  A span carries two clocks:

* **measured** — host wall seconds (``time.perf_counter`` deltas), i.e.
  what this Python process actually spent; the tracer never
  synchronizes the card, so a span around an asynchronous launch
  measures its enqueue;
* **modeled** — DRAM-clock seconds charged from ``timing.py`` /
  ``costmodel.py`` at the exact points where the ``Stats`` dataclasses
  accrue them.

Modeled charges are recorded as an *ordered* per-category event list, so
summing a category left-to-right reproduces the identical sequence of
floating-point additions the ``Stats`` accumulators performed — the
reconciliation tests assert bit-for-bit equality, not approximate
closeness.

On a card, a third number tells replay time apart from launch time:
each K5/K6 launch inside an open ``*.replay`` span is bracketed by a
pair of CUDA timing events (:meth:`Tracer.launch_begin` /
:meth:`Tracer.launch_end`), and when the round is harvested — where the
host waits for its copy back anyway — :meth:`Tracer.resolve_device`
adds the pair's elapsed time to the span's ``attrs["device_s"]``.  The
pair is read only once its end event has completed; nothing waits for
it.  On the CPU the attribute is absent.

Discipline (mirrors ``fault.py``): a *disabled* tracer is strictly free.
``active_tracer()`` returns ``None`` unless explicitly enabled, and every
instrumentation site guards with ``if tr is not None``: no span, no CUDA
event, no synchronization.

Alongside spans:

* a process-wide :class:`MetricsRegistry` (counters / gauges /
  histograms) that the ``Stats`` tiers publish into via
  :func:`publish_stats`;
* a bounded flight recorder: the last N root span trees are kept in a
  ring, and :meth:`Tracer.incident` snapshots them (plus any spans still
  open) for post-mortem on ``FaultExhaustedError`` or a serve-tier host
  fallback;
* exporters: Chrome trace-event JSON (Perfetto / ``chrome://tracing``;
  measured and modeled clocks as separate track groups, one track per
  bank/chip lane), a JSONL structured event log, and a per-stage
  aggregation.

The shared field-spec serialization used by ``BankStats`` /
``ChipStats`` / ``ChannelStats`` (:func:`spec_as_dict`) also lives here
so the tiers cannot drift apart key-by-key.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Span",
    "Tracer",
    "FlightRecord",
    "MetricsRegistry",
    "REGISTRY",
    "active_tracer",
    "span_or_null",
    "enable",
    "disable",
    "enabled",
    "publish_stats",
    "spec_as_dict",
    "chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "stage_summary",
]


# ---------------------------------------------------------------------------
# spans

# clock cycles the card spins before a traced launch's start event (about
# 0.5 ms at the H100's 1.98 GHz): longer than the host takes from that
# event to the kernel's launch, profiler callbacks included
LAUNCH_GATE_CYCLES = 1_000_000


@dataclass
class Span:
    """One stage of one dispatch, with a measured and a modeled clock."""

    name: str
    cat: str = "stage"
    lane: str = ""
    t0: float = 0.0  # perf_counter at begin()
    wall_s: float = 0.0  # measured host seconds (t1 - t0)
    attrs: Dict[str, Any] = field(default_factory=dict)
    # ordered (category, seconds) modeled charges accrued inside this span
    charges: List[Tuple[str, float]] = field(default_factory=list)
    children: List["Span"] = field(default_factory=list)
    seq: int = 0

    @property
    def modeled_s(self) -> float:
        """Modeled seconds charged directly to this span (exclusive)."""
        total = 0.0
        for _, s in self.charges:
            total += s
        return total

    @property
    def modeled_total_s(self) -> float:
        """Modeled seconds including all descendants (inclusive)."""
        total = self.modeled_s
        for child in self.children:
            total += child.modeled_total_s
        return total

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_record(self, parent: int = -1) -> Dict[str, Any]:
        return {
            "id": self.seq,
            "parent": parent,
            "name": self.name,
            "cat": self.cat,
            "lane": self.lane,
            "wall_s": self.wall_s,
            "modeled_s": self.modeled_s,
            "modeled_total_s": self.modeled_total_s,
            "attrs": dict(self.attrs),
        }


@dataclass
class FlightRecord:
    """A flight-recorder snapshot taken at an incident."""

    reason: str
    attrs: Dict[str, Any]
    roots: List[Span]
    open_spans: List[str]


class Tracer:
    """Collects nested dual-clock spans for the dispatch ladder.

    One dispatch at a time by design (the engines' dispatch guard and
    the serving front-end's single pump keep it so, whichever thread
    pumps); the open-span stack is plain process state.
    """

    def __init__(self, max_dispatches: int = 64, max_incidents: int = 16):
        self.max_dispatches = int(max_dispatches)
        self.roots: deque = deque(maxlen=self.max_dispatches)
        self.incidents: List[FlightRecord] = []
        self._max_incidents = int(max_incidents)
        self._stack: List[Span] = []
        self._seq = 0
        # chronological modeled charges per category, independent of span
        # structure — left-fold summation reproduces the Stats accumulators'
        # exact FP addition order (bit-for-bit reconciliation).
        self._charges: Dict[str, List[float]] = {}
        # (span, start, end) CUDA event pairs of launches not yet read
        self._launches: List[Tuple[Span, Any, Any]] = []

    # -- span lifecycle ----------------------------------------------------

    def begin(self, name: str, cat: str = "stage", lane: str = "", **attrs: Any) -> Span:
        self._seq += 1
        sp = Span(name=name, cat=cat, lane=lane, t0=time.perf_counter(),
                  attrs=dict(attrs), seq=self._seq)
        if self._stack:
            if not sp.lane:
                sp.lane = self._stack[-1].lane
            self._stack[-1].children.append(sp)
        self._stack.append(sp)
        return sp

    def end(self, span: Span, **attrs: Any) -> Span:
        span.wall_s = time.perf_counter() - span.t0
        if attrs:
            span.attrs.update(attrs)
        # pop through any spans left open below (defensive; normal paths
        # always end in LIFO order)
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        if not self._stack:
            self.roots.append(span)
        return span

    @property
    def depth(self) -> int:
        """Number of currently-open spans."""
        return len(self._stack)

    def unwind(self, depth: int = 0, **attrs: Any) -> None:
        """End every span open above ``depth``.

        Exception recovery: when a replay raises (e.g. a persistent
        fault aborts a dispatch), the spans it left open are closed here
        so the next dispatch does not nest under a stale tree.
        """
        while len(self._stack) > depth:
            self.end(self._stack[-1], **attrs)

    @contextmanager
    def span(self, name: str, cat: str = "stage", lane: str = "", **attrs: Any):
        sp = self.begin(name, cat=cat, lane=lane, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def event(self, name: str, cat: str = "event", lane: str = "",
              wall_s: float = 0.0, **attrs: Any) -> Span:
        """Record an instantaneous (or externally-timed) leaf span."""
        self._seq += 1
        sp = Span(name=name, cat=cat, lane=lane, t0=time.perf_counter() - wall_s,
                  wall_s=wall_s, attrs=dict(attrs), seq=self._seq)
        if self._stack:
            if not sp.lane:
                sp.lane = self._stack[-1].lane
            self._stack[-1].children.append(sp)
        else:
            self.roots.append(sp)
        return sp

    # -- the modeled clock -------------------------------------------------

    def charge(self, cat: str, seconds: float, span: Optional[Span] = None) -> None:
        """Charge modeled seconds to ``cat`` (and to the enclosing span).

        Call this at the same site, with the same value, as the ``Stats``
        accumulator it mirrors — ordering is what makes reconciliation
        bit-exact.
        """
        seconds = float(seconds)
        self._charges.setdefault(cat, []).append(seconds)
        target = span if span is not None else (self._stack[-1] if self._stack else None)
        if target is not None:
            target.charges.append((cat, seconds))

    def count(self, cat: str, n: int = 1) -> None:
        """Record a modeled count (e.g. a skipped transposition) as attrs."""
        if self._stack:
            attrs = self._stack[-1].attrs
            attrs[cat] = attrs.get(cat, 0) + n

    def modeled_total(self, cat: str) -> float:
        """Left-fold sum of every charge in ``cat`` (bit-exact vs Stats)."""
        total = 0.0
        for s in self._charges.get(cat, ()):
            total += s
        return total

    def modeled_categories(self) -> Tuple[str, ...]:
        return tuple(sorted(self._charges))

    def wall_total(self, name: Optional[str] = None) -> float:
        total = 0.0
        for root in self.roots:
            for sp in root.walk():
                if name is None or sp.name == name:
                    total += sp.wall_s
        return total

    # -- the device clock (CUDA only) --------------------------------------

    def launch_begin(self, device) -> Optional[Tuple[Span, Any]]:
        """Before a replay kernel's launch on ``device``: record a start
        event in the innermost open ``*.replay`` span, if there is one
        and the launch is on a card; returns the token
        :meth:`launch_end` takes (``None`` otherwise).

        The start event is queued behind a short spin on the card
        (``LAUNCH_GATE_CYCLES``), so that it completes only once the
        host has queued the kernel too: the pair then times the kernel,
        not the host's way to its launch.  The spin costs the card about
        half a millisecond a traced launch; the host does not wait."""
        if device.type != "cuda":
            return None
        for sp in reversed(self._stack):
            if sp.name.endswith(".replay"):
                import torch
                torch.cuda._sleep(LAUNCH_GATE_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                return sp, start
        return None

    def launch_end(self, token: Optional[Tuple[Span, Any]]) -> None:
        """After the launch: record its end event; the pair is read by
        :meth:`resolve_device` once the end event has completed."""
        if token is None:
            return
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._launches.append((token[0], token[1], end))

    def resolve_device(self) -> None:
        """Add the elapsed time of every completed launch pair to its
        span's ``attrs["device_s"]`` (seconds; the sum over the span's
        launches).  Pairs still running stay for a later call: this
        never waits."""
        waiting = []
        for sp, start, end in self._launches:
            if end.query():
                sp.attrs["device_s"] = (sp.attrs.get("device_s", 0.0)
                                        + start.elapsed_time(end) / 1e3)
            else:
                waiting.append((sp, start, end))
        self._launches = waiting

    # -- flight recorder ---------------------------------------------------

    def incident(self, reason: str, **attrs: Any) -> FlightRecord:
        """Snapshot the ring (plus open spans) for post-mortem."""
        rec = FlightRecord(
            reason=reason,
            attrs=dict(attrs),
            roots=list(self.roots),
            open_spans=[s.name for s in self._stack],
        )
        self.incidents.append(rec)
        if len(self.incidents) > self._max_incidents:
            self.incidents = self.incidents[-self._max_incidents:]
        return rec

    # -- maintenance -------------------------------------------------------

    def reset(self) -> None:
        self.roots.clear()
        self.incidents = []
        self._stack = []
        self._charges = {}
        self._launches = []

    @property
    def n_spans(self) -> int:
        return sum(1 for root in self.roots for _ in root.walk())


# ---------------------------------------------------------------------------
# the active tracer (disabled unless explicitly enabled — strictly free)

_ACTIVE: Optional[Tracer] = None


def active_tracer() -> Optional[Tracer]:
    """The process tracer, or ``None`` when telemetry is disabled."""
    return _ACTIVE


def enable(max_dispatches: int = 64) -> Tracer:
    """Install (or return) the process tracer."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = Tracer(max_dispatches=max_dispatches)
    return _ACTIVE


def disable() -> None:
    """Remove the process tracer; instrumentation reverts to no-ops."""
    global _ACTIVE
    _ACTIVE = None


_NO_SPAN = nullcontext()


def span_or_null(tr: Optional[Tracer], name: str, cat: str = "stage",
                 lane: str = "", **attrs: Any):
    """``tr.span(...)``, or a shared context that does nothing when
    ``tr`` is ``None`` (telemetry disabled)."""
    if tr is None:
        return _NO_SPAN
    return tr.span(name, cat=cat, lane=lane, **attrs)


@contextmanager
def enabled(max_dispatches: int = 64):
    """Scoped ``enable()`` — restores the previous tracer on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Tracer(max_dispatches=max_dispatches)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# metrics registry


class _Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "_samples")

    # every observation up to this many is kept exactly; beyond it the
    # reservoir decimates (keep-every-other), so percentile() stays
    # O(bounded) memory while count/total/min/max remain exact
    MAX_SAMPLES = 65536

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._samples.append(v)
        if len(self._samples) > self.MAX_SAMPLES:
            self._samples = self._samples[::2]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of the retained samples (exact until
        ``MAX_SAMPLES`` observations; decimated estimate beyond).
        ``q`` in [0, 100]; 0.0 on an empty histogram."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        rank = max(0, min(len(s) - 1,
                          int(math.ceil(q / 100.0 * len(s))) - 1))
        return s[rank]


class MetricsRegistry:
    """Process-wide named counters / gauges / histograms.

    The ``Stats`` tiers publish into this via :func:`publish_stats`;
    benchmarks snapshot it as their single source of truth instead of
    hand-copying fields.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, _Counter] = {}
        self._gauges: Dict[str, _Gauge] = {}
        self._histograms: Dict[str, _Histogram] = {}

    def counter(self, name: str) -> _Counter:
        return self._counters.setdefault(name, _Counter())

    def gauge(self, name: str) -> _Gauge:
        return self._gauges.setdefault(name, _Gauge())

    def histogram(self, name: str) -> _Histogram:
        return self._histograms.setdefault(name, _Histogram())

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Flat name → value dict (histograms expand to 4 sub-keys)."""
        out: Dict[str, Any] = {}
        for name, c in sorted(self._counters.items()):
            if name.startswith(prefix):
                out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            if name.startswith(prefix):
                out[name] = g.value
        for name, h in sorted(self._histograms.items()):
            if name.startswith(prefix) and h.count:
                out[f"{name}.count"] = h.count
                out[f"{name}.mean"] = h.mean
                out[f"{name}.min"] = h.min
                out[f"{name}.max"] = h.max
        return out

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


REGISTRY = MetricsRegistry()


def publish_stats(stats: Any, prefix: str, registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """Publish a ``Stats`` object's fields into the registry as gauges.

    ``stats`` is anything with ``as_dict()`` (all four Stats tiers).
    Nested dicts (e.g. the ``faults`` block) recurse with a dotted
    prefix; list-valued fields publish their sum and length. Returns the
    flat dict actually published.
    """
    reg = registry if registry is not None else REGISTRY
    flat: Dict[str, Any] = {}

    def _walk(d: Dict[str, Any], pre: str) -> None:
        for key, value in d.items():
            name = f"{pre}.{key}"
            if isinstance(value, dict):
                _walk(value, name)
            elif isinstance(value, (list, tuple)):
                flat[f"{name}.len"] = len(value)
                flat[f"{name}.sum"] = float(sum(value)) if value else 0.0
            elif isinstance(value, bool):
                flat[name] = 1.0 if value else 0.0
            elif isinstance(value, (int, float)):
                flat[name] = value

    _walk(stats.as_dict(), prefix)
    for name, value in flat.items():
        reg.gauge(name).set(float(value))
    return flat


# ---------------------------------------------------------------------------
# shared field-spec serialization for the Stats tiers
#
# Each Stats class declares only its OWN additions in a class-level
# ``_FIELD_SPEC`` tuple of (key, kind); spec_as_dict() walks the MRO
# base-first, so ChipStats/ChannelStats emit a strict superset of
# BankStats' keys without re-listing them. Kinds:
#   "int" / "float" / "bool"    — scalar casts
#   "int_list" / "float_list"   — per-lane arrays
#   "stats_if_any"              — nested Stats emitted only when .any

_SPEC_CASTS: Dict[str, Callable[[Any], Any]] = {
    "int": int,
    "float": float,
    "bool": bool,
    "int_list": lambda v: [int(x) for x in v],
    "float_list": lambda v: [float(x) for x in v],
}


def collect_field_spec(cls: type) -> Tuple[Tuple[str, str], ...]:
    """Merged (key, kind) spec across the MRO, base classes first."""
    merged: Dict[str, str] = {}
    for klass in reversed(cls.__mro__):
        for key, kind in getattr(klass, "_FIELD_SPEC", ()):  # own entries only
            merged[key] = kind
    return tuple(merged.items())


def spec_as_dict(obj: Any) -> Dict[str, Any]:
    """Serialize ``obj`` according to the merged ``_FIELD_SPEC``."""
    out: Dict[str, Any] = {}
    for key, kind in collect_field_spec(type(obj)):
        value = getattr(obj, key)
        if kind == "stats_if_any":
            if getattr(value, "any", False):
                out[key] = value.as_dict()
            continue
        out[key] = _SPEC_CASTS[kind](value)
    return out


# ---------------------------------------------------------------------------
# exporters

_MEASURED_PID = 1
_MODELED_PID = 2


def _lane_ids(roots: Sequence[Span]) -> Dict[str, int]:
    lanes = sorted({sp.lane or "main" for root in roots for sp in root.walk()})
    return {lane: i + 1 for i, lane in enumerate(lanes)}


def chrome_trace(tracer: Optional[Tracer] = None,
                 roots: Optional[Sequence[Span]] = None) -> Dict[str, Any]:
    """Build a Chrome trace-event JSON object (Perfetto-loadable).

    Two track groups (``pid``): measured host wall time and the modeled
    DRAM clock; one track (``tid``) per bank/chip lane within each.
    Modeled spans are laid out on a synthetic timeline — each span's
    inclusive modeled duration nests its children back-to-back — since
    the modeled clock has no real start times.
    """
    if roots is None:
        if tracer is None:
            tracer = active_tracer()
        roots = list(tracer.roots) if tracer is not None else []
    roots = [r for r in roots if r is not None]
    lane_of = _lane_ids(roots)
    events: List[Dict[str, Any]] = []

    events.append({"ph": "M", "pid": _MEASURED_PID, "tid": 0,
                   "name": "process_name", "args": {"name": "measured (host wall)"}})
    events.append({"ph": "M", "pid": _MODELED_PID, "tid": 0,
                   "name": "process_name", "args": {"name": "modeled (DRAM clock)"}})
    for lane, tid in lane_of.items():
        for pid in (_MEASURED_PID, _MODELED_PID):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": lane}})

    t_origin = min((root.t0 for root in roots), default=0.0)

    def _measured(sp: Span) -> None:
        events.append({
            "ph": "X",
            "pid": _MEASURED_PID,
            "tid": lane_of.get(sp.lane or "main", 1),
            "name": sp.name,
            "cat": sp.cat,
            "ts": (sp.t0 - t_origin) * 1e6,
            "dur": max(sp.wall_s, 0.0) * 1e6,
            "args": {"modeled_s": sp.modeled_s, **sp.attrs},
        })
        for child in sp.children:
            _measured(child)

    # modeled timeline: per-lane cursors; a span occupies its inclusive
    # modeled duration, children packed back-to-back from its start.
    cursors: Dict[int, float] = {}

    def _modeled(sp: Span, start_us: float) -> float:
        tid = lane_of.get(sp.lane or "main", 1)
        dur_us = sp.modeled_total_s * 1e6
        start_us = max(start_us, cursors.get(tid, 0.0))
        if dur_us > 0.0:
            events.append({
                "ph": "X",
                "pid": _MODELED_PID,
                "tid": tid,
                "name": sp.name,
                "cat": sp.cat,
                "ts": start_us,
                "dur": dur_us,
                "args": {"wall_s": sp.wall_s, **sp.attrs},
            })
        child_ts = start_us
        for child in sp.children:
            child_ts = _modeled(child, child_ts)
        cursors[tid] = max(cursors.get(tid, 0.0), start_us + dur_us)
        return start_us + dur_us

    ts = 0.0
    for root in roots:
        _measured(root)
        ts = _modeled(root, ts)

    meta: Dict[str, Any] = {"n_roots": len(roots)}
    if tracer is not None:
        meta["modeled_totals_s"] = {
            cat: tracer.modeled_total(cat) for cat in tracer.modeled_categories()
        }
        meta["n_incidents"] = len(tracer.incidents)
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": meta}


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None,
                       roots: Optional[Sequence[Span]] = None) -> Dict[str, Any]:
    trace = chrome_trace(tracer=tracer, roots=roots)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace


def write_jsonl(path: str, tracer: Optional[Tracer] = None) -> int:
    """Write one JSON object per span (flattened tree, parent ids)."""
    if tracer is None:
        tracer = active_tracer()
    roots = list(tracer.roots) if tracer is not None else []
    n = 0
    with open(path, "w") as fh:
        def _emit(sp: Span, parent: int) -> None:
            nonlocal n
            fh.write(json.dumps(sp.to_record(parent)) + "\n")
            n += 1
            for child in sp.children:
                _emit(child, sp.seq)
        for root in roots:
            _emit(root, -1)
    return n


def stage_summary(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-stage table from a Chrome trace dict: count, wall, modeled.

    Joins the measured and modeled track groups on span name.
    """
    stages: Dict[str, Dict[str, Any]] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        row = stages.setdefault(ev["name"], {
            "stage": ev["name"], "cat": ev.get("cat", ""),
            "count": 0, "wall_us": 0.0, "modeled_us": 0.0,
        })
        if ev["pid"] == _MEASURED_PID:
            row["count"] += 1
            row["wall_us"] += float(ev.get("dur", 0.0))
        elif ev["pid"] == _MODELED_PID:
            row["modeled_us"] += float(ev.get("dur", 0.0))
    out = sorted(stages.values(), key=lambda r: -r["wall_us"])
    for row in out:
        row["modeled_over_wall"] = (
            row["modeled_us"] / row["wall_us"] if row["wall_us"] > 0 else 0.0
        )
    return out
