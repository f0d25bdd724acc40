"""Fault tolerance for 1000+-node runs: detection, recovery, stragglers
(counterpart of :mod:`repro.train.fault_tolerance`, pure Python, copied
as it is).

Pieces (all testable on CPU; the cluster hooks are the same code paths a
real deployment wires to its orchestrator):

- HeartbeatMonitor: tracks per-host liveness from timestamps; declares a
  host dead after `timeout_s`.  The launcher polls it between steps.
- recovery_plan(): given alive hosts, picks the largest usable mesh
  (powers-of-two data axis, fixed model axis), returns the new mesh shape
  and whether a restore+reshard is required — elastic scale-down/up.
- StragglerPolicy: bounded-staleness step skipping — if a host's step
  latency exceeds p50·threshold, its gradient contribution is dropped for
  that step (scale correction keeps the estimate unbiased); repeated
  offenders are proposed for eviction.
- simulate_failure_and_recover(): end-to-end drill used by tests — train,
  "kill" a host, re-mesh, restore from the latest checkpoint, continue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    n_hosts: int
    timeout_s: float = 60.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, t: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if t is None else t

    def alive(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h in range(self.n_hosts)
                if now - self.last_seen.get(h, -1e18) <= self.timeout_s]

    def dead(self, now: Optional[float] = None) -> List[int]:
        a = set(self.alive(now))
        return [h for h in range(self.n_hosts) if h not in a]


def recovery_plan(
    n_alive_chips: int, model_parallel: int, chips_per_pod: int = 256
) -> Dict:
    """Largest (pod, data, model) mesh that fits the alive chips.

    model_parallel is fixed by the checkpointed layout; data axis shrinks
    to the largest power of two; pods = alive full pods (≥1).
    """
    assert n_alive_chips >= model_parallel, "cannot keep TP degree"
    pods = max(1, n_alive_chips // chips_per_pod)
    per_pod = n_alive_chips // pods
    data = 1
    while data * 2 * model_parallel <= per_pod:
        data *= 2
    used = pods * data * model_parallel
    return {
        "mesh_shape": (pods, data, model_parallel),
        "chips_used": used,
        "chips_idle": n_alive_chips - used,
        "needs_reshard": True,
        "batch_scale": used / float(pods * data * model_parallel),
    }


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 2.0          # × median step latency
    evict_after: int = 5            # consecutive slow steps
    history: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    slow_streak: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, host: int, latency_s: float) -> None:
        self.history.setdefault(host, []).append(latency_s)

    def median_latency(self) -> float:
        import statistics
        allv = [v for h in self.history.values() for v in h[-16:]]
        return statistics.median(allv) if allv else 0.0

    def classify(self) -> Tuple[List[int], List[int]]:
        """-> (skip_this_step, propose_evict)"""
        med = self.median_latency()
        skip, evict = [], []
        for h, hist in self.history.items():
            if not hist:
                continue
            if med > 0 and hist[-1] > self.threshold * med:
                self.slow_streak[h] = self.slow_streak.get(h, 0) + 1
                skip.append(h)
                if self.slow_streak[h] >= self.evict_after:
                    evict.append(h)
            else:
                self.slow_streak[h] = 0
        return skip, evict

    def gradient_scale(self, n_hosts: int, n_skipped: int) -> float:
        """Unbiased rescale when skipping straggler contributions."""
        kept = max(1, n_hosts - n_skipped)
        return n_hosts / kept


def simulate_failure_and_recover(train_fn, save_fn, restore_fn,
                                 steps_before: int, steps_after: int) -> Dict:
    """Drill used by tests: run, checkpoint, 'lose' a host, remesh, resume."""
    state = train_fn(None, steps_before)
    save_fn(state)
    plan = recovery_plan(n_alive_chips=384, model_parallel=16)
    state2 = restore_fn()
    state3 = train_fn(state2, steps_after)
    return {"plan": plan, "final_state": state3}
