"""Fault model, detection, bounded retry, and graceful degradation.

Counterpart of :mod:`repro.core.fault`, copied but for two points:
injection runs on the K6 kernel (:func:`repro_torch.core.control_unit
.faulty_bank_replay`), whose random bits come from Philox, not
``jax.random``; and states move to the device of the wave's tables and
back as int32 bit-views.  The tracer calls (the ``fault.execute`` span,
the ``fault.inject``/``retry``/``vote``/``redispatch`` events, the
``fault`` charges and the ``fault_exhausted`` incident) are the
reference's.  Every :class:`FaultStats` field is counted as in the reference, and
everything drawn with numpy (dead units, stuck masks, Philox keys)
equals the reference's draws.

The paper's §5 reliability study shows triple-row activation is the
fragile primitive: process variation past ~±20 % flips sense-amp
outcomes, and real-chip characterization (PULSAR, arXiv:2312.02880; the
many-row activation study, arXiv:2405.06081) measures non-trivial,
spatially-clustered bit-error rates on off-the-shelf parts.  This module
makes the execution ladder *survive* those errors instead of assuming a
perfect DRAM oracle:

  1. **Model** — :class:`FaultModel` holds the per-activation TRA
     bit-flip probability (derived from
     :func:`repro_torch.core.reliability.tra_failure_breakdown` for a given
     (σ, tech node)), clustered stuck-at column rates, and whole-
     subarray failure rates; :class:`FaultRuntime` realizes it per bank
     under a seeded PRNG so every run is reproducible.  Injection
     happens inside the replay kernel
     (:func:`repro_torch.core.control_unit.faulty_bank_replay`), with masks
     and counter-based Philox bits.

  2. **Detection** — spare-lane modular redundancy: each logical lane
     is replicated across ``spare_lanes + 1`` adjacent columns
     (:func:`replicate_queue`), and :func:`faulty_execute` majority-
     votes the replicas at unpack.  With ``spare_lanes == 0`` the
     dispatcher falls back to a dispatch-level double-execution
     checksum: the wave replays twice with fresh fault draws and the
     two transcripts are compared per lane — no column overhead, but
     2× replay latency and (documented) blindness to stuck-at faults,
     which corrupt both runs identically.  Detection cost is priced in
     the cost model (:func:`repro_torch.core.costmodel.vote_cost_s`,
     :func:`repro_torch.core.timing.fault_replay_overhead_s`).

  3. **Recovery** — bounded per-tier retry: an undecided lane re-replays
     its whole wave/round/super-round with fresh fault draws, up to
     ``max_retries`` attempts; lanes accepted earlier keep their first
     accepted value.  Units (subarrays) still undecided after the cap
     raise :class:`_PersistentFault`, the tier blacklists them, the LPT
     packers repack the queue around the blacklist, and the dispatch
     replays — up to ``max_redispatches`` times before
     :class:`FaultExhaustedError` reaches the caller (the serving path
     catches it and falls back to the host oracle).

:class:`FaultStats` counts the whole story (injected / detected /
corrected / retries / redispatches / remapped units / modeled overhead)
and threads through ``BankStats``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .control_unit import output_plane_rows
from .costmodel import vote_cost_s
from .subarray import pack_bits, unpack_bits
from .telemetry import active_tracer, spec_as_dict
from .timing import DDR4, DramConfig, fault_replay_overhead_s

# stuck-at column patterns are drawn once per subarray over the physical
# row width, so a subarray's defective bitlines are identical in every
# wave regardless of how wide the simulated state happens to be
_PHYS_COLUMNS = 65536


class FaultExhaustedError(RuntimeError):
    """Dispatch could not produce a trusted result: every retry tier
    (wave re-replay, unit blacklist + repack) was exhausted, or no
    fault-free capacity remains.  The serving tiers catch this and fall
    back to the host oracle.

    Carries structured context so incident records and breaker decisions
    never have to parse the message: ``cause`` (``"no_capacity"`` or
    ``"redispatch_budget"``), ``tier`` (``"bank"``/``"chip"``/
    ``"channel"`` — empty for legacy raises), ``blacklist`` (the tier's
    blacklisted unit coordinates at raise time), ``retries`` /
    ``redispatches`` (the :class:`FaultStats` counters at raise time)
    and ``capacity`` (fault-free subarrays remaining)."""

    def __init__(self, message: str, *, cause: str = "",
                 tier: str = "",
                 blacklist: Sequence[Tuple[int, ...]] = (),
                 retries: int = 0, redispatches: int = 0,
                 capacity: int = 0):
        super().__init__(message)
        self.cause = cause
        self.tier = tier
        self.blacklist = tuple(tuple(int(x) for x in u) for u in blacklist)
        self.retries = int(retries)
        self.redispatches = int(redispatches)
        self.capacity = int(capacity)

    def context(self) -> Dict[str, object]:
        """The structured exhaustion context as flat, JSON-able fields —
        what incident records and serving-tier breakers attach instead
        of the bare message."""
        return {
            "cause": self.cause,
            "tier": self.tier,
            "blacklist": [list(u) for u in self.blacklist],
            "blacklisted_units": len(self.blacklist),
            "retries": self.retries,
            "redispatches": self.redispatches,
            "capacity": self.capacity,
        }


class _PersistentFault(Exception):
    """Internal: a replay left lanes undecided after ``max_retries``
    attempts.  ``units`` are the ladder coordinates of the offending
    subarrays — ``(sid,)`` at bank tier, ``(bank, sid)`` at chip tier,
    ``(chip, bank, sid)`` at channel tier."""

    def __init__(self, units: Sequence[Tuple[int, ...]]):
        super().__init__(f"persistent faults in units {sorted(units)}")
        self.units = tuple(sorted(set(map(tuple, units))))


@functools.lru_cache(maxsize=64)
def _derived_flip_p(sigma: float, tech_node: str, n_trials: int) -> float:
    from .reliability import TECH_NODES, tra_failure_breakdown
    return tra_failure_breakdown(
        sigma, TECH_NODES[tech_node], n_trials)["overall"]


@dataclass(frozen=True)
class FaultModel:
    """Configurable DRAM fault model for the whole ladder.

    ``sigma``/``tech_node`` feed the reliability Monte-Carlo to derive
    the per-activation per-bit flip probability (``p_flip`` overrides it
    directly, e.g. for property tests that need statistical power).
    ``stuck_lane_rate`` is the probability a physical column is stuck
    (at 0 or 1, drawn 50/50), clustered in runs of ``stuck_cluster``
    adjacent columns — the spatial clustering real-chip studies measure.
    ``dead_unit_rate`` is the probability a whole subarray is dead.

    ``spare_lanes`` is the modular-redundancy degree: each logical lane
    occupies ``spare_lanes + 1`` physical columns and results are
    majority-voted.  ``0`` selects the dispatch-level double-execution
    checksum instead (temporal redundancy).  ``max_retries`` bounds
    re-replays per wave; ``max_redispatches`` bounds blacklist-and-
    repack rounds per dispatch.
    """

    sigma: float = 0.15
    tech_node: str = "17nm"
    p_flip: Optional[float] = None       # override the derived rate
    p_trials: int = 200_000              # Monte-Carlo trials for derivation
    stuck_lane_rate: float = 0.0
    stuck_cluster: int = 4
    dead_unit_rate: float = 0.0
    spare_lanes: int = 1
    max_retries: int = 3
    max_redispatches: int = 2
    seed: int = 0
    enabled: bool = True

    def __post_init__(self):
        if self.p_flip is not None and not 0.0 <= self.p_flip <= 1.0:
            raise ValueError("p_flip must be a probability in [0, 1]")
        for name in ("stuck_lane_rate", "dead_unit_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability in [0, 1]")
        if self.spare_lanes < 0:
            raise ValueError("spare_lanes must be >= 0")
        if self.max_retries < 0 or self.max_redispatches < 0:
            raise ValueError("retry caps must be >= 0")
        if self.stuck_cluster < 1:
            raise ValueError("stuck_cluster must be >= 1")

    @property
    def replicas(self) -> int:
        """Physical columns per logical lane."""
        return self.spare_lanes + 1

    def flip_probability(self) -> float:
        """Per-activation per-bit flip probability — the ``overall``
        rate of :func:`repro_torch.core.reliability.tra_failure_breakdown`
        for this (σ, tech node), unless ``p_flip`` overrides it."""
        if self.p_flip is not None:
            return float(self.p_flip)
        return _derived_flip_p(float(self.sigma), self.tech_node,
                               int(self.p_trials))


@dataclass
class FaultStats:
    """Counters for the fault layer, one per engine tier.

    ``injected`` — AP bit flips the interpreter injected;
    ``checks`` — per-lane majority/checksum comparisons performed;
    ``detected`` — lane-votes where at least one replica disagreed;
    ``corrected`` — lanes whose accepted value required a majority
    correction or a retry; ``retries`` — extra replay attempts;
    ``redispatches`` — blacklist-and-repack rounds; ``remapped`` —
    units blacklisted; ``host_fallbacks`` — dispatches abandoned to the
    host oracle (serving path); ``overhead_s`` — modeled seconds of
    redundant replays + votes, folded into ``total_latency_s``.
    """

    injected: int = 0
    checks: int = 0
    detected: int = 0
    corrected: int = 0
    retries: int = 0
    redispatches: int = 0
    remapped: int = 0
    host_fallbacks: int = 0
    overhead_s: float = 0.0

    _FIELD_SPEC = (
        ("injected", "int"),
        ("checks", "int"),
        ("detected", "int"),
        ("corrected", "int"),
        ("retries", "int"),
        ("redispatches", "int"),
        ("remapped", "int"),
        ("host_fallbacks", "int"),
        ("overhead_s", "float"),
    )

    @property
    def any(self) -> bool:
        return any((self.injected, self.checks, self.detected,
                    self.corrected, self.retries, self.redispatches,
                    self.remapped, self.host_fallbacks,
                    self.overhead_s > 0.0))

    def as_dict(self) -> Dict[str, float]:
        return spec_as_dict(self)


def _pack_col_mask(bits: np.ndarray) -> np.ndarray:
    """(n_cols,) bool -> (n_cols//32,) uint32 in the lane layout (lane
    *l* ↦ bit ``l % 32`` of word ``l // 32``)."""
    b = bits.reshape(-1, 32).astype(np.uint32)
    return np.sum(b << np.arange(32, dtype=np.uint32), axis=1,
                  dtype=np.uint32)


class FaultRuntime:
    """One bank's realized fault state under a seeded PRNG.

    Draws the persistent defects once at construction — dead subarrays
    and clustered stuck-at columns over the physical row width
    (``_PHYS_COLUMNS``), so a subarray's defect pattern is identical in
    every wave — and hands out fresh per-attempt flip keys from a
    deterministic stream.  ``seed_path`` namespaces the ladder
    coordinates (``(chip, bank)`` etc.) so every unit in a channel gets
    an independent but reproducible draw.
    """

    def __init__(self, model: FaultModel, seed_path: Tuple[int, ...],
                 n_units: int):
        self.model = model
        self.n_units = n_units
        rng = np.random.default_rng((model.seed,) + tuple(seed_path))
        self.dead = rng.random(n_units) < model.dead_unit_rate
        words = _PHYS_COLUMNS // 32
        self._s0 = np.zeros((n_units, words), np.uint32)
        self._s1 = np.zeros((n_units, words), np.uint32)
        if model.stuck_lane_rate > 0.0:
            for u in range(n_units):
                stuck = self._draw_stuck(rng)
                pol = rng.random(_PHYS_COLUMNS) < 0.5
                self._s1[u] = _pack_col_mask(stuck & pol)
                self._s0[u] = _pack_col_mask(stuck & ~pol)
        self._key_rng = rng

    def _draw_stuck(self, rng) -> np.ndarray:
        m = self.model
        starts = rng.random(_PHYS_COLUMNS) < (
            m.stuck_lane_rate / m.stuck_cluster)
        mask = np.zeros(_PHYS_COLUMNS + m.stuck_cluster, bool)
        for s in np.nonzero(starts)[0]:
            mask[s: s + m.stuck_cluster] = True
        return mask[:_PHYS_COLUMNS]

    def stuck_masks(self, n_words: int) -> Tuple[np.ndarray, np.ndarray]:
        """(stuck0, stuck1) word masks for a state of ``n_words`` words —
        a prefix of the physical pattern, so widths never change which
        columns are defective."""
        return self._s0[:, :n_words], self._s1[:, :n_words]

    def draw_keys(self) -> np.ndarray:
        """(n_units, 2) uint32 — fresh per-attempt PRNG keys, advanced
        deterministically from the runtime's seed."""
        return self._key_rng.integers(
            0, 1 << 32, size=(self.n_units, 2), dtype=np.uint32)


# ---------------------------------------------------------------------------
# spare-lane replication (detection degree r = spare_lanes + 1)
# ---------------------------------------------------------------------------

def _replicate_operand(o, r: int):
    from .bank import Ref, VerticalOperand
    if isinstance(o, Ref):
        return o                     # producers are already replicated
    if isinstance(o, VerticalOperand):
        n_bits = int(o.planes.shape[0])
        vals = unpack_bits(np.ascontiguousarray(o.planes), o.lanes)
        rep = np.tile(vals, r)
        cols = -(-max(len(rep), 1) // 32) * 32
        return VerticalOperand(pack_bits(rep, n_bits, cols), len(rep))
    a = np.asarray(o)
    return np.tile(a, (1,) * (a.ndim - 1) + (r,))


def replicate_queue(queue, r: int) -> List:
    """Replicate every horizontal/vertical operand ``r``× with a
    *strided* layout: replica *j* of logical lane *l* sits at physical
    column ``j*L + l`` (L = logical lane count).  Striding — rather
    than placing replicas adjacently — keeps a spatial cluster of
    stuck-at columns from covering every replica of one lane, which
    would let the vote agree on a wrong clamped value.  ``Ref``
    operands pass through — their producers are replicated too, so the
    forwarded planes already carry the replicas."""
    if r == 1:
        return list(queue)
    return [dataclasses.replace(
        ins, operands=tuple(_replicate_operand(o, r) for o in ins.operands))
        for ins in queue]


def _dereplicate_one(x, r: int):
    from .bank import VerticalOperand
    if isinstance(x, tuple):
        return tuple(_dereplicate_one(v, r) for v in x)
    if isinstance(x, VerticalOperand):
        n_bits = int(x.planes.shape[0])
        vals = unpack_bits(np.ascontiguousarray(x.planes), x.lanes)
        vals = vals[:len(vals) // r]
        cols = -(-max(len(vals), 1) // 32) * 32
        return VerticalOperand(pack_bits(vals, n_bits, cols), len(vals))
    a = np.asarray(x)
    return a[..., :a.shape[-1] // r]


def dereplicate_results(results, r: int) -> List:
    """Project replicated dispatch results back to logical lanes (the
    healed replicas are identical, so the first-replica prefix works)."""
    if r == 1:
        return list(results)
    return [_dereplicate_one(x, r) for x in results]


# ---------------------------------------------------------------------------
# faulty execution: inject -> vote -> retry -> heal (one replay unit)
# ---------------------------------------------------------------------------

def _majority(grid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-lane majority over a (L, r) replica grid: returns (candidate
    value, its multiplicity).  The sorted middle element is always a
    strict-majority value when one exists."""
    s = np.sort(grid, axis=1)
    cand = s[:, grid.shape[1] // 2]
    cnt = np.sum(grid == cand[:, None], axis=1)
    return cand, cnt


def faulty_execute(model: FaultModel, run: Callable, states: np.ndarray,
                   tables, slabs, stats: FaultStats,
                   cfg: DramConfig = DDR4) -> np.ndarray:
    """Execute one replay unit (wave / round / super-round) under fault
    injection with detection, bounded retry, and healing.

    Args:
        model: the :class:`FaultModel` in force.
        run: the tier's faulty executor —
            ``run(states, tables, keys, stuck0, stuck1, dead, p)`` →
            ``(out_states, flip_counts)``, in the unit order; a split
            executor returns them in host memory, put together from its
            slabs.
        states: the packed host-side state stack; every axis before the
            last two is a unit axis, the last unit axis is subarrays.
        tables: the stacked device-resident command tables with their
            schedule (a :class:`~repro_torch.core.control_unit
            .CommandTables`).
        slabs: ``[(idx, entries, runtime), ...]`` — ``idx`` indexes the
            unit axes *before* the subarray axis (``()`` at bank tier,
            ``(b,)`` at chip tier, ``(c, b)`` at channel tier),
            ``entries`` the occupied :class:`repro_torch.core.bank._Slot`
            list, ``runtime`` that bank's :class:`FaultRuntime`.
        stats: the tier's :class:`FaultStats` to accumulate into.

    Returns:
        The healed executed state stack (a numpy array — the harvest
        paths treat it exactly like a drained device future): every
        entry's output planes hold the majority-voted values, repeated
        across the replicas.

    Raises:
        _PersistentFault: lanes still undecided after ``max_retries``
            extra attempts — carries the unit coordinates to blacklist.
    """
    r = model.replicas
    runs_per_attempt = 2 if r == 1 else 1
    unit_shape = states.shape[:-2]
    n_words = states.shape[-1]
    tr = active_tracer()
    sp = None
    if tr is not None:
        sp = tr.begin("fault.execute", cat="fault", slabs=len(slabs),
                      replicas=r)

    s0 = np.zeros(unit_shape + (n_words,), np.uint32)
    s1 = np.zeros(unit_shape + (n_words,), np.uint32)
    dead = np.zeros(unit_shape, bool)
    for idx, _, rt in slabs:
        m0, m1 = rt.stuck_masks(n_words)
        s0[idx], s1[idx] = m0, m1
        dead[idx] = rt.dead
    # ``tables`` lives on the wave's device; the rest crosses to it once,
    # and only the keys change between runs
    dev = tables.tables.device

    def to_dev(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)

    states_dev = to_dev(states)
    s0_dev, s1_dev = to_dev(s0), to_dev(s1)
    dead_dev = to_dev(dead)
    p = np.float32(model.flip_probability())

    ents = [(idx, e) for idx, entries, _ in slabs for e in entries]
    rows_of = [output_plane_rows(e.spec.out_bits, e.uprog)
               for _, e in ents]
    for _, e in ents:
        if e.lanes % r:
            raise RuntimeError(
                f"entry lanes {e.lanes} not a multiple of replicas {r}; "
                "fault-protected dispatch must replicate the queue first")
    acc_ok = [np.zeros(e.lanes // r, bool) for _, e in ents]
    acc_vals = [[np.zeros(e.lanes // r, np.uint64)
                 for _ in e.spec.out_bits] for _, e in ents]

    # modeled price of ONE replay of this unit: slabs run concurrently,
    # so the unit costs its slowest slab's wave
    from .bank import wave_cost
    base_s = max((wave_cost([(e.uprog, e.lanes, e.sid) for e in entries],
                            cfg).latency_s
                  for _, entries, _ in slabs if entries), default=0.0)

    total_runs = 0
    last_out: Optional[np.ndarray] = None
    for attempt in range(model.max_retries + 1):
        outs = []
        for _ in range(runs_per_attempt):
            keys = np.zeros(unit_shape + (2,), np.uint32)
            for idx, _, rt in slabs:
                keys[idx] = rt.draw_keys()
            out_dev, nflips = run(states_dev, tables, to_dev(keys),
                                  s0_dev, s1_dev, dead_dev, p)
            flips = int(nflips.sum())
            stats.injected += flips
            if sp is not None:
                tr.event("fault.inject", cat="fault", attempt=attempt,
                         flips=flips)
            outs.append(out_dev.cpu().numpy().view(np.uint32))
            total_runs += 1
        last_out = outs[-1]
        if attempt:
            stats.retries += 1
            if sp is not None:
                tr.event("fault.retry", cat="fault", attempt=attempt)

        for j, (idx, e) in enumerate(ents):
            if acc_ok[j].all():
                continue
            L = e.lanes // r
            open_ = ~acc_ok[j]
            ok_round = np.ones(L, bool)
            vals_round = []
            disagree = np.zeros(L, bool)
            for rows in rows_of[j]:
                cols = [unpack_bits(
                    np.ascontiguousarray(o[idx + (e.sid,)][rows]),
                    e.lanes).reshape(r, L).T for o in outs]
                grid = np.concatenate(cols, axis=1)
                v, cnt = _majority(grid)
                ok_round &= cnt * 2 > grid.shape[1]
                disagree |= (grid != grid[:, :1]).any(axis=1)
                vals_round.append(v)
                stats.checks += int(open_.sum())
            stats.detected += int(np.sum(disagree & open_))
            newly = ok_round & open_
            stats.corrected += int(np.sum(
                newly & (disagree | bool(attempt))))
            for o, v in enumerate(vals_round):
                acc_vals[j][o][newly] = v[newly]
            acc_ok[j] |= newly

        vote_s = sum(
            vote_cost_s(e.lanes // r, sum(e.spec.out_bits), r, cfg)
            for j, (_, e) in enumerate(ents) if not acc_ok[j].all()
        ) + sum(
            vote_cost_s(e.lanes // r, sum(e.spec.out_bits), r, cfg)
            for j, (_, e) in enumerate(ents) if acc_ok[j].all())
        stats.overhead_s += vote_s
        if sp is not None:
            tr.event("fault.vote", cat="fault", attempt=attempt,
                     undecided=sum(1 for ok in acc_ok if not ok.all()))
            tr.charge("fault", vote_s, span=sp)
        if all(ok.all() for ok in acc_ok):
            break
    else:
        bad = [idx + (e.sid,) for j, (idx, e) in enumerate(ents)
               if not acc_ok[j].all()]
        replay_s = fault_replay_overhead_s(base_s, total_runs - 1)
        stats.overhead_s += replay_s
        if sp is not None:
            tr.charge("fault", replay_s, span=sp)
            tr.end(sp, runs=total_runs, persistent_units=len(bad))
        raise _PersistentFault(bad)

    replay_s = fault_replay_overhead_s(base_s, total_runs - 1)
    stats.overhead_s += replay_s
    if sp is not None:
        tr.charge("fault", replay_s, span=sp)

    # heal: write the voted values back into the output planes (repeated
    # across replicas) so harvest and plane forwarding read clean data
    final = last_out.copy()
    n_cols = final.shape[-1] * 32
    for j, (idx, e) in enumerate(ents):
        sub = final[idx + (e.sid,)]
        for o, rows in enumerate(rows_of[j]):
            vals = np.tile(acc_vals[j][o], r)
            sub[list(rows)] = pack_bits(vals, e.spec.out_bits[o], n_cols)
    if sp is not None:
        tr.end(sp, runs=total_runs)
    return final


# ---------------------------------------------------------------------------
# dispatch-level degradation: blacklist -> repack -> re-dispatch
# ---------------------------------------------------------------------------

def fault_guarded_dispatch(model: FaultModel, stats: FaultStats, queue,
                           dispatch_core: Callable,
                           blacklist_units: Callable,
                           capacity: Callable,
                           tier: str = "",
                           blacklist_snapshot: Optional[Callable] = None
                           ) -> List:
    """The per-tier dispatch wrapper: replicate the queue, drain it
    through ``dispatch_core`` (whose replays inject faults and may raise
    :class:`_PersistentFault`), blacklist failing units and repack, and
    give up with :class:`FaultExhaustedError` when the redispatch budget
    or the fault-free capacity runs out.

    ``tier`` names the caller (``"bank"``/``"chip"``/``"channel"``) and
    ``blacklist_snapshot`` returns its blacklisted unit coordinates —
    both feed the structured :class:`FaultExhaustedError` context and
    the flight-recorder incident so post-mortems see *where* the
    redundancy budget died, not just that it did."""
    queue = list(queue)
    if not queue:
        return []
    r = model.replicas
    rep = replicate_queue(queue, r)
    tr = active_tracer()
    depth0 = tr.depth if tr is not None else 0

    def _exhaust(cause: str, message: str) -> FaultExhaustedError:
        err = FaultExhaustedError(
            message, cause=cause, tier=tier,
            blacklist=blacklist_snapshot() if blacklist_snapshot else (),
            retries=stats.retries, redispatches=stats.redispatches,
            capacity=int(capacity()))
        if tr is not None:
            tr.incident("fault_exhausted", **err.context())
        return err

    for _ in range(model.max_redispatches + 1):
        if capacity() <= 0:
            raise _exhaust("no_capacity",
                           "no fault-free subarrays left to repack onto")
        try:
            res = dispatch_core(rep)
        except _PersistentFault as pf:
            if tr is not None:
                # close the spans the aborted dispatch left open so the
                # re-dispatch does not nest under a stale tree
                tr.unwind(depth0)
            stats.redispatches += 1
            stats.remapped += int(blacklist_units(pf.units))
            if tr is not None:
                tr.event("fault.redispatch", cat="fault",
                         blacklisted=len(pf.units))
            continue
        return dereplicate_results(res, r)
    raise _exhaust(
        "redispatch_budget",
        f"persistent faults survived {model.max_redispatches + 1} "
        "dispatch attempts")
