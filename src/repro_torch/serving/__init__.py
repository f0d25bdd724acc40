"""``repro_torch.serving`` — the multi-tenant request-stream tier.

Counterpart of :mod:`repro.serving`.

The front door of the ladder: many concurrent client streams submit
single-bbop requests with deadlines and priorities; the front-end
applies admission control, coalesces compatible requests across tenants
into shared waves, drains them through one engine dispatch, and fans
results back out to per-request tickets — degrading gracefully (typed
rejections, host-oracle fallback behind a per-tenant circuit breaker)
instead of stalling or crashing under overload and injected faults.

    from repro_torch.serving import ServingFrontend

    fe = ServingFrontend()              # owns a SimdramChannel on "cuda"
    t = fe.submit("alice", "addition", (a, b), n_bits=8,
                  deadline_s=fe.now_s + 1e-3)
    fe.drain()                                   # or fe.start() a worker
    print(t.result())

Strictly free when unused: importing this package, and the engines'
``cancel``/re-entrancy hooks, change nothing about the synchronous
``dispatch`` path (no extra launch, bit-identical results).
"""

from .frontend import (  # noqa: F401
    AdmissionRejected,
    BreakerState,
    CircuitBreaker,
    DeadlineExceeded,
    FrontendStats,
    ServingFrontend,
    Ticket,
)

__all__ = [
    "AdmissionRejected",
    "BreakerState",
    "CircuitBreaker",
    "DeadlineExceeded",
    "FrontendStats",
    "ServingFrontend",
    "Ticket",
]
