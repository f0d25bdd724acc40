"""Chip-level partitioned execution: N banks of M subarrays each.

Counterpart of :mod:`repro.core.chip`, with the reference's tracer
calls (``chip.*`` spans, ``bank.wave`` events and ``bank.busy`` /
``chip.replay`` charges on per-bank lanes).  The end-to-end SIMDRAM
paper's control unit allocates work across *banks*: the 1/4/16-bank
sweep that produces the headline 88× CPU throughput runs one
compute-enabled subarray per bank in lockstep.  Here:

  - a :class:`SimdramChip` owns ``n_banks`` :class:`~repro_torch.core
    .bank.Bank` instances and stacks their wave slabs into one
    ``(n_banks, n_subarrays, n_rows, n_words)`` array — one *chip round*
    replays every bank's fused wave in a single K5 launch over all
    ``n_banks × n_subarrays`` units
    (:func:`repro_torch.core.control_unit.chip_replay`, through
    :func:`repro_torch.distributed.pum.make_chip_executor`), or one
    launch a bank slab when the round is split across a device mesh;
  - :meth:`SimdramChip.dispatch` is the partitioned front-end: the
    queue's Ref-connected producer→consumer chains are indivisible units
    (operand forwarding stays bank-local — planes never cross banks), and
    units are bin-packed onto banks longest-processing-time-first so
    modeled per-bank loads balance; within each bank the cross-stage
    reordering scheduler takes over, and each round's stacked command
    tables resolve from :data:`repro_torch.core.control_unit.TABLE_CACHE`,
    flattened to ``(n_banks × n_subarrays, n_cmds, 13)`` with the
    schedule of every unit of the round;
  - host packing of round *k+1* overlaps the replay of round *k*: the
    launch and the copy of its states back to pinned host memory are
    enqueued together, and round *k* is read after round *k+1* was
    submitted, as :class:`~repro_torch.core.bank.Bank` does for waves;
  - :class:`ChipStats` extends :class:`~repro_torch.core.bank.BankStats`
    with per-bank utilization, cross-bank imbalance, and the
    modeled-vs-measured latency pair (``latency_s`` vs
    ``wall_s``/``pack_wall_s``): a chip round models the *slowest bank's*
    wave — banks replay concurrently.

Bit-exactness: chip dispatch == sequential per-bank ``Bank.dispatch`` ==
the reference's chip dispatch (tests/test_torch_chip.py).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import resolve_device
from .bank import (Bank, BankStats, BbopInstr, Ref, _Slot,
                   _build_stacked_tables, drain_stacked, plan_queue,
                   submit_stacked, wait_stacked)
from .control_unit import CMD_WIDTH, TABLE_CACHE
from .costmodel import instr_cost_s
from .isa import DispatchGuard, check_cancel
from .telemetry import active_tracer, span_or_null
from .timing import DDR4, DramConfig, chip_round_latency_s


@dataclass
class ChipStats(BankStats):
    """Aggregate cost model for everything a :class:`SimdramChip` ran.

    Inherited fields aggregate over all banks (``n_subarrays`` is the
    chip TOTAL, ``subarray_programs`` is flattened bank-major), with two
    semantic refinements: ``latency_s`` models banks replaying
    *concurrently* — each round charges its slowest bank's wave, which
    itself charges its longest constituent μProgram — and ``batches``
    counts per-bank waves while :attr:`rounds` counts stacked chip
    replays (one K5 launch each).  ``wall_s``/``pack_wall_s`` are the
    measured host-side counterparts of ``latency_s``.
    """

    n_banks: int = 1
    rounds: int = 0                              # stacked chip replays
    bank_busy_s: np.ndarray = field(default=None)  # type: ignore

    # chip-tier additions to the inherited BankStats spec (keys merge
    # across the MRO in spec_as_dict)
    _FIELD_SPEC = (
        ("n_banks", "int"),
        ("rounds", "int"),
        ("bank_busy_s", "float_list"),
        ("bank_programs", "int_list"),
        ("utilization", "float_list"),
        ("imbalance", "float"),
    )

    def __post_init__(self):
        super().__post_init__()
        if self.bank_busy_s is None:
            self.bank_busy_s = np.zeros(self.n_banks)

    @property
    def bank_programs(self) -> np.ndarray:
        """Instructions executed per bank (the scheduler's balance)."""
        return self.subarray_programs.reshape(self.n_banks, -1).sum(axis=1)

    @property
    def utilization(self) -> np.ndarray:
        """Per-bank busy fraction of the chip's modeled wall-clock."""
        if not self.latency_s:
            return np.zeros(self.n_banks)
        return self.bank_busy_s / self.latency_s

    @property
    def imbalance(self) -> float:
        """Slowest bank's busy time over the mean — 1.0 is a perfectly
        balanced schedule, n_banks is all work on one bank."""
        if not self.bank_busy_s.any():
            return 0.0
        return float(self.bank_busy_s.max() / self.bank_busy_s.mean())


def partition_queue(queue, active, lanes, n_banks: int,
                    cfg: DramConfig = DDR4, style: str = "mig",
                    allowed: Optional[Sequence[int]] = None
                    ) -> Dict[int, int]:
    """Assign instructions to banks: Ref-connected components are
    indivisible (forwarded planes never cross banks), weighted by
    :func:`repro_torch.core.costmodel.instr_cost_s`, and bin-packed
    longest-processing-time-first onto the least-loaded bank.

    ``allowed`` restricts the candidate banks (the fault layer passes
    the non-blacklisted set so degraded dispatches repack around retired
    banks); ``None`` means all ``n_banks``."""
    parent = {i: i for i in active}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    act = set(active)
    for i in active:
        for o in queue[i].operands:
            if isinstance(o, Ref) and o.producer in act:
                parent[find(i)] = find(o.producer)
    comps: Dict[int, List[int]] = {}
    for i in active:
        comps.setdefault(find(i), []).append(i)
    cost = {
        root: sum(instr_cost_s(queue[i].op, queue[i].n_bits, lanes[i],
                               cfg, style) for i in members)
        for root, members in comps.items()
    }
    pool = list(range(n_banks)) if allowed is None else sorted(allowed)
    if not pool:
        raise ValueError("partition_queue: no banks allowed")
    load = np.zeros(n_banks)
    bank_of: Dict[int, int] = {}
    for root, members in sorted(
            comps.items(), key=lambda kv: (-cost[kv[0]], kv[0])):
        b = pool[int(np.argmin(load[pool]))]
        load[b] += cost[root]
        for i in members:
            bank_of[i] = b
    return bank_of


def remap_sub_queue(queue, idxs) -> List[BbopInstr]:
    """The instructions ``idxs`` of ``queue`` as a queue of their own,
    ``Ref`` producers renumbered (every producer must be in ``idxs``)."""
    remap = {qi: j for j, qi in enumerate(idxs)}
    return [
        dataclasses.replace(
            queue[qi],
            operands=tuple(
                Ref(remap[o.producer], o.out) if isinstance(o, Ref) else o
                for o in queue[qi].operands))
        for qi in idxs
    ]


def sequential_dispatch(queue: Sequence[BbopInstr], n_banks: int = 4,
                        n_subarrays: int = 4, cfg: DramConfig = DDR4,
                        style: str = "mig", fuse: bool = True,
                        packing: str = "reorder", device="cuda"):
    """The no-chip baseline: the *same* bank partition a
    :class:`SimdramChip` would use, executed one bank at a time on
    separate :class:`~repro_torch.core.bank.Bank` instances.

    Returns ``(results, banks)`` — results in queue order (bit-exactness
    reference for chip dispatch), and the per-bank ``Bank`` objects whose
    summed ``stats.latency_s`` is the serialized cost the chip's
    concurrent-banks model (max per round) improves on.
    """
    queue = list(queue)
    results: List = [None] * len(queue)
    banks = [Bank(n_subarrays=n_subarrays, cfg=cfg, style=style,
                  fuse=fuse, packing=packing, device=device)
             for _ in range(n_banks)]
    if not queue:
        return results, banks
    lanes, _, _ = plan_queue(queue, style)
    active = [i for i in range(len(queue)) if lanes[i] > 0]
    for i in range(len(queue)):
        if lanes[i] == 0:
            results[i] = banks[0]._empty_result(queue[i])
    bank_of = partition_queue(queue, active, lanes, n_banks, cfg, style)
    for b, bank in enumerate(banks):
        idxs = [i for i in active if bank_of[i] == b]
        if not idxs:
            continue
        for qi, out in zip(idxs, bank.dispatch(remap_sub_queue(queue, idxs))):
            results[qi] = out
    return results, banks


class SimdramChip:
    """``n_banks`` banks × ``n_subarrays`` subarrays, one stacked replay.

    All banks run the fused ``interp`` engine (heterogeneous waves,
    vertical operand forwarding); the chip stacks one wave per bank into
    each round and replays the round in one K5 launch on ``device``.
    ``mesh``/``use_shard_map`` select the executor
    (:func:`repro_torch.distributed.pum.make_chip_executor`): a
    ``("data",)`` mesh splits each round into bank slabs, one launch a
    slab on its position's device and stream; ``device`` stays the home
    of the round's tables.  Without a mesh the banks split over the
    visible devices of ``device`` when several fit.
    """

    def __init__(self, n_banks: int = 4, n_subarrays: int = 4,
                 cfg: DramConfig = DDR4, style: str = "mig",
                 fuse_ratio: int = 32, packing: str = "reorder",
                 mesh=None, use_shard_map: Optional[bool] = None,
                 fault=None, fault_seed: Tuple[int, ...] = (),
                 device="cuda"):
        if n_banks < 1:
            raise ValueError("n_banks must be >= 1")
        from ..distributed.pum import (make_chip_executor,
                                       make_faulty_chip_executor)
        self.n_banks = n_banks
        self.n_subarrays = n_subarrays
        self.cfg = cfg
        self.style = style
        self.device = resolve_device(device)
        self.fault = fault if (fault is not None and fault.enabled) else None
        self.banks = [
            Bank(n_subarrays=n_subarrays, cfg=cfg, style=style,
                 engine="interp", fuse=True, fuse_ratio=fuse_ratio,
                 packing=packing, fault=self.fault,
                 fault_seed=tuple(fault_seed) + (b,), device=self.device)
            for b in range(n_banks)
        ]
        self.executor = make_chip_executor(
            n_banks, mesh=mesh, use_shard_map=use_shard_map,
            device=self.device)
        self._faulty_executor = (
            make_faulty_chip_executor(n_banks, mesh=mesh,
                                      use_shard_map=use_shard_map,
                                      device=self.device)
            if self.fault is not None else None)
        self.stats = ChipStats(n_subarrays=n_banks * n_subarrays,
                               n_banks=n_banks)
        self._guard = DispatchGuard("SimdramChip")
        self._lane = "chip"          # telemetry track label
        for b, bank in enumerate(self.banks):
            bank._lane = f"bank{b}"

    # -- scheduling --------------------------------------------------------
    def _partition(self, queue, active, lanes) -> Dict[int, int]:
        allowed = ([b for b in range(self.n_banks)
                    if self.banks[b]._wave_capacity > 0]
                   if self.fault is not None else None)
        return partition_queue(queue, active, lanes, self.n_banks,
                               self.cfg, self.style, allowed=allowed)

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, queue: Sequence[BbopInstr], cancel=None) -> List:
        """Drain a bbop queue across all banks.

        Args:
            queue: sequence of :class:`~repro_torch.core.bank.BbopInstr`.
                ``Ref`` operands must point at earlier queue entries;
                Ref-connected chains are scheduled as indivisible units
                and never split across banks (forwarded bit-planes stay
                bank-local).

        Returns:
            One result per instruction, in queue order: an int64 array
            per output (tuple for multi-output ops), or
            :class:`~repro_torch.core.bank.VerticalOperand` planes when the
            instruction set ``keep_vertical=True``.

        Costs accumulate in :attr:`stats` (a :class:`ChipStats`: modeled
        ``latency_s`` charges the slowest bank per round — banks replay
        concurrently — while ``wall_s``/``pack_wall_s`` record measured
        host time) and in each participating bank's own stats.

        With a :class:`~repro_torch.core.fault.FaultModel` attached, the
        queue replicates across spare lanes and each chip round replays
        under fault injection (one K6 launch per attempt) with
        majority-vote detection, bounded retry, and bank/subarray
        blacklist-and-repack — see :mod:`repro_torch.core.fault`.

        ``cancel`` (optional zero-arg callable) is polled at round
        boundaries; returning True aborts with
        :class:`~repro_torch.core.isa.DispatchCancelled`.  Concurrent
        calls on one engine raise ``RuntimeError``."""
        with self._guard:
            queue = list(queue)
            if self.fault is None or not queue:
                return self._dispatch_core(queue, cancel=cancel)
            from .fault import fault_guarded_dispatch
            return fault_guarded_dispatch(
                self.fault, self.stats.faults, queue,
                lambda q: self._dispatch_core(q, cancel=cancel),
                self._blacklist_units,
                lambda: sum(b._wave_capacity for b in self.banks),
                tier="chip",
                blacklist_snapshot=lambda: tuple(sorted(
                    (b, s) for b in range(self.n_banks)
                    for s in self.banks[b]._blacklist)))

    def _dispatch_core(self, queue: Sequence[BbopInstr],
                       cancel=None) -> List:
        queue = list(queue)
        results: List = [None] * len(queue)
        if not queue:
            return results           # clean no-op: stats stay zeroed
        tr = active_tracer()
        root = (tr.begin("chip.dispatch", cat="dispatch", lane=self._lane,
                         instrs=len(queue)) if tr is not None else None)
        t0 = time.perf_counter()
        self.stats.bbops += len(queue)
        with span_or_null(tr, "chip.plan", cat="plan"):
            lanes, stage, needed = plan_queue(queue, self.style)
        planes_cache: Dict[Tuple[int, int], np.ndarray] = {}
        active = []
        for i in range(len(queue)):
            if lanes[i] == 0:
                self.banks[0]._skip_zero_lane(
                    queue, i, needed, planes_cache, results)
            else:
                active.append(i)
        if not active:               # all-zero-lane queue: no replay
            self.stats.wall_s += time.perf_counter() - t0
            if root is not None:
                tr.end(root)
            return results

        sp = tr.begin("chip.schedule", cat="plan") if tr is not None else None
        bank_of = self._partition(queue, active, lanes)
        for i in active:
            self.banks[bank_of[i]].stats.bbops += 1
        waves_by_bank = [
            self.banks[b]._build_waves(
                queue, [i for i in active if bank_of[i] == b], stage, lanes)
            for b in range(self.n_banks)
        ]
        if sp is not None:
            tr.end(sp, banks=len(set(bank_of.values())))
        n_rounds = max(len(w) for w in waves_by_bank)
        pending = None               # (entries_by_bank, states, event)
        for r in range(n_rounds):
            check_cancel(cancel, "chip round boundary")
            round_waves = [(b, waves_by_bank[b][r])
                           for b in range(self.n_banks)
                           if r < len(waves_by_bank[b])]
            if pending is not None:
                # stage barrier: a round forwarding planes from the
                # still-in-flight round drains it before packing
                in_flight = {e.qi for _, ents in pending[0] for e in ents}
                if any(isinstance(o, Ref) and o.producer in in_flight
                       for _, wave in round_waves
                       for i in wave for o in queue[i].operands):
                    self._harvest_round(queue, pending, planes_cache,
                                        needed, results)
                    pending = None
            entries_by_bank, fut = self._pack_round(
                queue, round_waves, lanes, planes_cache)
            self._account_round(queue, entries_by_bank)
            if pending is not None:
                # double buffering: round k harvests only after round
                # k+1 was packed and submitted
                self._harvest_round(queue, pending, planes_cache, needed,
                                    results)
            pending = (entries_by_bank, *fut)
        if pending is not None:
            with span_or_null(tr, "chip.drain", cat="drain"):
                wait_stacked(pending[-1])      # drain the pipeline
            self._harvest_round(queue, pending, planes_cache, needed, results)
        self.stats.wall_s += time.perf_counter() - t0
        if root is not None:
            tr.end(root)
        return results

    def _round_dims(self, queue, round_waves, lanes) -> Tuple[int, int, int]:
        """(n_rows, n_cmds, cols) ONE chip round needs — the max of its
        participating banks' wave dims.  The channel-level dispatcher
        maxes these across chips so every chip's round packs into one
        stacked (n_chips, n_banks, n_subarrays, ...) super-round."""
        dims = [self.banks[b]._wave_dims(queue, wave, lanes)
                for b, wave in round_waves]
        return (max(d[0] for d in dims), max(d[1] for d in dims),
                max(d[2] for d in dims))

    def _pack_round_states(self, queue, round_waves, lanes, planes_cache,
                           n_rows: int, n_cmds: int, cols: int):
        """Pack one chip round's state slab at the given dims (NOP
        commands and zero rows are inert; idle banks stay all-NOP).

        Returns ``(states, bank_keys, entries_by_bank)`` — the raw
        (n_banks, n_subarrays, n_rows, n_words) uint32 array, the
        per-bank wave keys, and the per-bank slot entries — without
        resolving tables or submitting a replay, so the channel
        dispatcher can stack several chips' rounds into one super-round
        replay.  Bank-level transpose savings/payments accrued while
        packing are mirrored into this chip's stats."""
        states = np.zeros(
            (self.n_banks, self.n_subarrays, n_rows, cols // 32), np.uint32)
        entries_by_bank: List[Tuple[int, List[_Slot]]] = []
        bank_keys: List = [None] * self.n_banks
        tr = active_tracer()
        for b, wave in round_waves:
            bank = self.banks[b]
            sp = (tr.begin("bank.pack_wave", cat="pack", lane=bank._lane)
                  if tr is not None else None)
            skips0 = bank.stats.transpositions_skipped
            saved0 = bank.stats.transpose_s_saved
            paid0 = bank.stats.transpose_s
            st, wave_key, entries = bank._pack_wave(
                queue, wave, lanes, planes_cache,
                n_rows=n_rows, n_cmds=n_cmds, cols=cols, with_tables=False)
            if sp is not None:
                tr.end(sp, slots=len(entries))
            self.stats.transpositions_skipped += (
                bank.stats.transpositions_skipped - skips0)
            self.stats.transpose_s_saved += (
                bank.stats.transpose_s_saved - saved0)
            self.stats.transpose_s += bank.stats.transpose_s - paid0
            states[b] = st
            bank_keys[b] = wave_key
            entries_by_bank.append((b, entries))
        return states, bank_keys, entries_by_bank

    def _pack_round(self, queue, round_waves, lanes, planes_cache):
        """Stack one wave per participating bank into the chip arrays and
        submit the round.

        Every bank's slab is padded to the round's max (rows, cmds, cols)
        — NOP commands and zero rows are inert — so one launch replays
        all banks; idle banks stay all-NOP.  The round's tables, flattened
        to (n_banks × n_subarrays, n_cmds, 13) with their schedule, come
        from :data:`~repro_torch.core.control_unit.TABLE_CACHE`, keyed by
        the whole round's composition: a repeated round pays zero
        host-side table work.  Returns ``(entries_by_bank, (states,
        event))``."""
        tr = active_tracer()
        t_pack = time.perf_counter()
        sp = (tr.begin("chip.pack_round", cat="pack", banks=len(round_waves))
              if tr is not None else None)
        n_rows, n_cmds, cols = self._round_dims(queue, round_waves, lanes)
        states, bank_keys, entries_by_bank = self._pack_round_states(
            queue, round_waves, lanes, planes_cache, n_rows, n_cmds, cols)
        tables = TABLE_CACHE.get(
            ("chip", self.n_banks, self.n_subarrays, n_cmds,
             tuple(bank_keys), str(self.device)),
            lambda: self._build_round_tables(bank_keys, n_cmds).reshape(
                -1, n_cmds, CMD_WIDTH),
            self.device)
        if sp is not None:
            tr.end(sp)
        pack_s = time.perf_counter() - t_pack
        self.stats.pack_wall_s += pack_s
        for b, _ in round_waves:
            self.banks[b].stats.pack_wall_s += pack_s / len(round_waves)
        with span_or_null(tr, "chip.replay", cat="replay",
                          banks=len(round_waves)):
            fut = self._submit_round(states, tables, entries_by_bank)
        return entries_by_bank, fut

    def _submit_round(self, states, tables, entries_by_bank):
        """Submit one stacked chip round; returns ``(states, event)``.
        Fault-free: one K5 launch and the copy back behind it
        (:func:`submit_stacked`).  Fault-injected: the synchronous
        detect/retry/heal loop over the chip-tier faulty executor (one K6
        launch per attempt); its healed host states need no event."""
        if self.fault is None:
            return submit_stacked(self.executor.run, states, tables)
        from .fault import faulty_execute
        slabs = [((b,), entries, self.banks[b]._fault_rt)
                 for b, entries in entries_by_bank]
        return faulty_execute(
            self.fault, self._faulty_executor.run, states, tables,
            slabs, self.stats.faults, self.cfg), None

    def _blacklist_units(self, units) -> int:
        """Retire persistently-failing subarrays (``units`` are
        ``(bank, sid)`` tuples); returns how many are newly
        blacklisted."""
        new = 0
        for u in units:
            b, sid = int(u[-2]), int(u[-1])
            if sid not in self.banks[b]._blacklist:
                self.banks[b]._blacklist.add(sid)
                new += 1
        return new

    def _build_round_tables(self, bank_keys, n_cmds: int) -> np.ndarray:
        """Materialize one chip round's stacked (n_banks, n_subarrays,
        n_cmds, 13) tables (the table cache's build function — runs once
        per distinct round composition)."""
        out = np.zeros(
            (self.n_banks, self.n_subarrays, n_cmds, CMD_WIDTH), np.int32)
        for b, key in enumerate(bank_keys):
            if key is None:
                continue
            style, _cmds, slot_ops = key
            out[b] = _build_stacked_tables(
                (style, n_cmds, slot_ops), self.n_subarrays)
        return out

    def _account_round(self, queue, entries_by_bank):
        """Charge one chip round: each bank's wave accounts on the bank
        (latency there = that wave), while the chip charges the round's
        max across banks — banks replay concurrently.  All costs come
        from :func:`repro_torch.core.bank.wave_cost`.  Returns the
        round's ``bank_waves`` so the channel-level dispatcher can apply
        the same max rule one tier up
        (:func:`repro_torch.core.timing.channel_round_latency_s`)."""
        st = self.stats
        st.rounds += 1
        bank_waves = []
        for b, entries in entries_by_bank:
            idxs = [e.qi for e in entries]
            fused = len({(queue[i].op, queue[i].n_bits, queue[i].signed_out)
                         for i in idxs}) > 1
            c = self.banks[b]._account_wave(
                [(e.uprog, e.lanes, e.sid) for e in entries], fused=fused)
            st.add_wave(c, fused, concurrent=True)
            st.bank_busy_s[b] += c.latency_s
            tr = active_tracer()
            if tr is not None:
                # per-bank modeled busy time on the bank's own lane (the
                # round charges the max across banks; this shows each
                # bank's term of it)
                ev = tr.event("bank.wave", cat="replay",
                              lane=self.banks[b]._lane, slots=len(entries))
                tr.charge("bank.busy", c.latency_s, span=ev)
            for e in entries:
                st.subarray_programs[b * self.n_subarrays + e.sid] += 1
            bank_waves.append((c.uprogs, c.invocations))
        round_s = chip_round_latency_s(bank_waves, self.cfg)
        st.latency_s += round_s
        tr = active_tracer()
        if tr is not None:
            tr.charge("chip.replay", round_s)
        return bank_waves

    def _harvest_round(self, queue, pending, planes_cache, needed, results):
        """Materialize one completed chip round (waiting for its states to
        arrive on the host)."""
        entries_by_bank, fut, done = pending
        with span_or_null(active_tracer(), "chip.unpack", cat="unpack"):
            self._harvest_banks(queue, entries_by_bank,
                                drain_stacked(fut, done), planes_cache,
                                needed, results)

    def _harvest_round_out(self, queue, entries_by_bank, out, planes_cache,
                           needed, results):
        """Harvest an executed (n_banks, n_subarrays, n_rows, n_words)
        host array, bank slab by bank slab (forwarded planes published
        per bank — chains are bank-local), in a ``chip.unpack`` span as
        the reference's channel and rank harvests open one per chip."""
        with span_or_null(active_tracer(), "chip.unpack", cat="unpack"):
            self._harvest_banks(queue, entries_by_bank, out, planes_cache,
                                needed, results)

    def _harvest_banks(self, queue, entries_by_bank, out, planes_cache,
                       needed, results):
        for b, entries in entries_by_bank:
            bank = self.banks[b]
            skips0 = bank.stats.transpositions_skipped
            saved0 = bank.stats.transpose_s_saved
            paid0 = bank.stats.transpose_s
            bank._harvest_out(queue, entries, out[b], planes_cache, needed,
                              results)
            self.stats.transpositions_skipped += (
                bank.stats.transpositions_skipped - skips0)
            self.stats.transpose_s_saved += (
                bank.stats.transpose_s_saved - saved0)
            self.stats.transpose_s += bank.stats.transpose_s - paid0

    # -- ISA front-end -----------------------------------------------------
    def bbop(self, name: str, *operands, n_bits: int,
             signed_out: bool = False):
        """One bbop whose lanes span the whole chip: elements split into
        contiguous chunks, one per (bank, subarray) slot, and drain in
        (ideally) one chip round."""
        return spread_bbop(self, self.n_banks * self.n_subarrays, name,
                           operands, n_bits, signed_out)

    def reset_stats(self):
        self.stats = ChipStats(n_subarrays=self.n_banks * self.n_subarrays,
                               n_banks=self.n_banks)
        for bank in self.banks:
            bank.reset_stats()


def spread_bbop(engine, slots: int, name: str, operands, n_bits: int,
                signed_out: bool):
    """One bbop whose lanes span an engine's ``slots`` units: elements
    split into contiguous chunks, one instruction per unit, dispatched as
    one queue and reassembled in order."""
    arrs = [np.asarray(o) for o in operands]
    n = arrs[0].shape[-1]
    if n == 0:
        return engine.dispatch(
            [BbopInstr(name, tuple(arrs), n_bits, signed_out=signed_out)])[0]
    per = max(1, -(-n // slots))
    queue = [
        BbopInstr(name, tuple(a[..., s: s + per] for a in arrs), n_bits,
                  signed_out=signed_out)
        for s in range(0, n, per)
    ]
    results = engine.dispatch(queue)
    if isinstance(results[0], tuple):
        return tuple(np.concatenate([r[i] for r in results], axis=-1)
                     for i in range(len(results[0])))
    return np.concatenate(results, axis=-1)
