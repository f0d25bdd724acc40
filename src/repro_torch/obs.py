"""``repro_torch.obs`` — the one-import observability facade.

Counterpart of :mod:`repro.obs`: a thin re-export layer over
:mod:`repro_torch.core.telemetry` so user code never reaches into
``core`` for tracing:

    from repro_torch import obs

    obs.enable()                       # dual-clock tracing on
    device.dispatch(queue)
    obs.write_chrome_trace("trace.json")   # open in Perfetto
    obs.publish_stats(engine.stats, "bank")
    print(obs.REGISTRY.snapshot())
    obs.disable()                      # back to the strictly-free path

``obs.span(...)`` is safe to call whether or not tracing is enabled —
it no-ops (cheaply) when the tracer is off, so application code does
not need its own guards.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, List

from .core.telemetry import (  # noqa: F401  (re-exports)
    REGISTRY,
    FlightRecord,
    MetricsRegistry,
    Span,
    Tracer,
    active_tracer,
    chrome_trace,
    disable,
    enable,
    enabled,
    publish_stats,
    stage_summary,
    write_chrome_trace,
    write_jsonl,
)

__all__ = [
    "REGISTRY",
    "FlightRecord",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "active_tracer",
    "chrome_trace",
    "disable",
    "enable",
    "enabled",
    "publish_stats",
    "stage_summary",
    "write_chrome_trace",
    "write_jsonl",
    "span",
    "charge",
    "count",
    "gauge",
    "observe",
    "incident",
    "incidents",
    "reset",
]


@contextmanager
def span(name: str, cat: str = "stage", lane: str = "", **attrs: Any):
    """Open a span on the active tracer; no-op when tracing is disabled."""
    tr = active_tracer()
    if tr is None:
        yield None
        return
    with tr.span(name, cat=cat, lane=lane, **attrs) as sp:
        yield sp


def charge(cat: str, seconds: float) -> None:
    """Charge modeled seconds to the active tracer, if any."""
    tr = active_tracer()
    if tr is not None:
        tr.charge(cat, seconds)


def count(name: str, delta: int = 1) -> None:
    """Bump a registry counter (always on — the registry is process-wide
    and does not depend on the tracer being enabled)."""
    REGISTRY.counter(name).inc(delta)


def gauge(name: str, value: float) -> None:
    """Set a registry gauge to ``value``."""
    REGISTRY.gauge(name).set(value)


def observe(name: str, value: float) -> None:
    """Record ``value`` in a registry histogram (mean/min/max and
    nearest-rank percentiles via ``REGISTRY.histogram(name)``)."""
    REGISTRY.histogram(name).observe(value)


def incident(reason: str, **attrs: Any):
    """Snapshot the flight recorder, if tracing is enabled."""
    tr = active_tracer()
    if tr is not None:
        return tr.incident(reason, **attrs)
    return None


def incidents() -> List[FlightRecord]:
    tr = active_tracer()
    return list(tr.incidents) if tr is not None else []


def reset() -> None:
    """Clear the active tracer's spans/charges and the metrics registry."""
    tr = active_tracer()
    if tr is not None:
        tr.reset()
    REGISTRY.reset()
