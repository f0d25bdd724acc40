"""Channel-level partitioned execution: N chips × M banks × K subarrays.

Counterpart of :mod:`repro.core.channel`, with the reference's tracer
calls (``channel.*`` spans, ``chip.round`` events, the DMA charges
``channel.transfer.h2d``/``.d2h``/``.overlapped`` with their bytes, on
per-chip and per-bank lanes).  The end-to-end SIMDRAM framework
projects near-linear throughput gains as more DRAM structures compute in
parallel, *bounded by the host-side memory channel*: chips on a channel
share nothing compute-side, but every horizontal operand and result
crosses ONE shared link priced at ``cfg.channel_bw_gbs``.  Here:

  - a :class:`SimdramChannel` owns ``n_chips``
    :class:`~repro_torch.core.chip.SimdramChip` instances and stacks their
    per-round slabs into one ``(n_chips, n_banks, n_subarrays, n_rows,
    n_words)`` array — one *super-round* replays every chip's round in a
    single K5 launch over all its units
    (:func:`repro_torch.core.control_unit.channel_replay`), or one a
    slab of a device mesh; the member chips never submit replays of
    their own;
  - :meth:`SimdramChannel.dispatch` bin-packs Ref-connected chains onto
    chips (chains stay chip-local), longest-processing-time-first; within
    each chip the bank partitioner and wave schedulers take over
    unchanged, and each super-round's stacked tables resolve from
    :data:`repro_torch.core.control_unit.TABLE_CACHE` keyed by the whole
    super-round's composition;
  - :class:`ChannelStats` extends :class:`~repro_torch.core.bank.BankStats`
    with per-chip utilization and the DMA-style host↔chip transfer
    model: traffic is per-direction (``h2d_bw_gbs`` in, ``d2h_bw_gbs``
    out) and burst-granular (``link_burst_bytes``), and with
    ``cfg.transfer_overlap`` the inputs of super-round *k+1* stream in
    and the outputs of *k−1* drain out while *k* replays
    (:class:`_DmaSchedule`); only the *exposed* remainder reaches
    ``total_latency_s`` and the transfer-bound crossover point.

Bit-exactness: channel dispatch == sequential per-chip
``SimdramChip.dispatch`` == the reference's channel dispatch
(tests/test_torch_channel.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import resolve_device
from .bank import (BankStats, BbopInstr, Ref, VerticalOperand, _Slot,
                   cached_table, drain_stacked, plan_queue, submit_stacked,
                   wait_stacked)
from .chip import SimdramChip, partition_queue, remap_sub_queue, spread_bbop
from .control_unit import CMD_WIDTH, TABLE_CACHE
from .costmodel import (transfer_bytes_d2h, transfer_bytes_h2d,
                        transfer_crossover_chips)
from .isa import DispatchGuard, check_cancel
from .telemetry import active_tracer, span_or_null
from .timing import (DDR4, DramConfig, burst_rounded_bytes,
                     channel_round_latency_s, d2h_transfer_s, h2d_transfer_s)

# chip-stats fields the channel mirrors by before/after diffing when it
# delegates a super-round's packing/accounting/harvest to its chips
_MIRROR = ("batches", "fused_batches", "elements", "aap", "ap", "energy_nj")
_TRANSPOSE = ("transpositions_skipped", "transpose_s_saved", "transpose_s")


def _mirror(dst, src, fields, snap) -> None:
    """Add ``src``'s growth in ``fields`` since ``snap`` to ``dst``."""
    for f, v0 in zip(fields, snap):
        setattr(dst, f, getattr(dst, f) + getattr(src, f) - v0)


@dataclass
class ChannelStats(BankStats):
    """Aggregate cost model for everything a :class:`SimdramChannel` ran.

    Inherited fields aggregate over all chips (``n_subarrays`` is the
    channel TOTAL, ``subarray_programs`` is flattened chip-major then
    bank-major): ``latency_s`` models chips replaying *concurrently* —
    each super-round charges its slowest chip's round — while
    ``wall_s``/``pack_wall_s`` are the measured host-side counterparts.

    The channel adds the DMA transfer model: ``transfer_bytes`` is every
    horizontal operand/result that crossed the host↔DRAM link,
    burst-rounded per super-round slice and priced per direction into
    ``transfer_h2d_s`` / ``transfer_d2h_s`` (:attr:`transfer_s` is their
    sum).  With ``cfg.transfer_overlap`` the double-buffered engine hides
    slices behind replay (``transfer_overlapped_s``), and only the
    *exposed* remainder (:attr:`exposed_transfer_s`) reaches
    :attr:`total_latency_s`, :attr:`transfer_bound`, and
    :attr:`crossover_chips`.
    """

    n_chips: int = 1
    n_banks: int = 1
    super_rounds: int = 0                        # stacked channel replays
    transfer_bytes: int = 0                      # host↔chip traffic (rounded)
    transfer_h2d_s: float = 0.0                  # host→DRAM, at h2d_bw_gbs
    transfer_d2h_s: float = 0.0                  # DRAM→host, at d2h_bw_gbs
    transfer_overlapped_s: float = 0.0           # hidden behind replay
    chip_busy_s: np.ndarray = field(default=None)  # type: ignore

    # channel-tier additions to the inherited BankStats spec
    _FIELD_SPEC = (
        ("n_chips", "int"),
        ("n_banks", "int"),
        ("super_rounds", "int"),
        ("transfer_bytes", "int"),
        ("transfer_h2d_s", "float"),
        ("transfer_d2h_s", "float"),
        ("transfer_s", "float"),
        ("transfer_overlapped_s", "float"),
        ("exposed_transfer_s", "float"),
        ("transfer_bound", "bool"),
        ("crossover_chips", "float"),
        ("chip_busy_s", "float_list"),
        ("chip_programs", "int_list"),
        ("utilization", "float_list"),
        ("imbalance", "float"),
    )

    def __post_init__(self):
        super().__post_init__()
        if self.chip_busy_s is None:
            self.chip_busy_s = np.zeros(self.n_chips)

    @property
    def chip_programs(self) -> np.ndarray:
        """Instructions executed per chip (the scheduler's balance)."""
        return self.subarray_programs.reshape(self.n_chips, -1).sum(axis=1)

    @property
    def utilization(self) -> np.ndarray:
        """Per-chip busy fraction of the channel's modeled wall-clock."""
        if not self.latency_s:
            return np.zeros(self.n_chips)
        return self.chip_busy_s / self.latency_s

    @property
    def imbalance(self) -> float:
        """Slowest chip's busy time over the mean — 1.0 is a perfectly
        balanced schedule, n_chips is all work on one chip."""
        if not self.chip_busy_s.any():
            return 0.0
        return float(self.chip_busy_s.max() / self.chip_busy_s.mean())

    @property
    def transfer_s(self) -> float:
        """Total modeled link occupancy, both directions — what a fully
        serialized (no-overlap) engine would expose end to end."""
        return self.transfer_h2d_s + self.transfer_d2h_s

    @property
    def exposed_transfer_s(self) -> float:
        """Transfer time that actually extends the modeled wall-clock:
        total link occupancy minus what the double-buffered DMA schedule
        hid behind super-round replay.  Equals :attr:`transfer_s`
        bit-for-bit when ``cfg.transfer_overlap`` is off."""
        return self.transfer_s - self.transfer_overlapped_s

    @property
    def total_latency_s(self) -> float:
        """Replay latency + paid transpositions + *exposed* host↔chip
        transfers + fault-layer overhead (zero when injection is off) —
        the end-to-end modeled wall-clock this tier is bounded by."""
        return (self.latency_s + self.transpose_s + self.exposed_transfer_s
                + self.faults.overhead_s)

    @property
    def transfer_bound(self) -> bool:
        """True when the shared link's *exposed* (post-overlap) time
        costs more than compute — adding chips past this point cannot
        help."""
        return self.exposed_transfer_s >= self.latency_s > 0.0

    @property
    def crossover_chips(self) -> float:
        """The transfer-bound crossover point for THIS dispatch's mix:
        serial compute over *exposed* transfer time
        (:func:`repro_torch.core.costmodel.transfer_crossover_chips`)."""
        return transfer_crossover_chips(
            float(self.chip_busy_s.sum()), self.exposed_transfer_s)


class _DmaSchedule:
    """One dispatch's DMA transfer schedule over the shared host link.

    ``plan`` splits the queue's host↔DRAM traffic into per-super-round,
    per-direction slices (burst-rounded — never undercharged), and
    ``after_round`` charges them as the replay loop completes each
    super-round.  With ``cfg.transfer_overlap`` the modeled timeline is
    the classic double-buffered DMA pipeline::

        h2d[0] │ max(replay[0], h2d[1])           │ …   fill prologue
               │ max(replay[r], h2d[r+1], d2h[r-1]) │ …   steady state
               │ max(replay[n-1], d2h[n-2])        │ d2h[n-1]   drain

    i.e. the inputs of super-round *k+1* stream in and the outputs of
    super-round *k−1* drain out while *k* replays.  Each slot charges the
    full per-direction link occupancy and the hidden portion (``h2d +
    d2h − exposed``) into ``transfer_overlapped_s`` — so ``overlapped ≥
    0``, ``exposed ≤ serial``, and the overlap-off path equals the serial
    engine exactly in IEEE floats.  The same schedule serves the channel
    and rank tiers (``prefix`` names the telemetry categories:
    ``{prefix}.transfer.h2d`` / ``.d2h`` / ``.overlapped``); charges land
    at the same sites and in the same order as the Stats accumulators.
    """

    def __init__(self, stats: ChannelStats, cfg: DramConfig, lane: str,
                 prefix: str = "channel"):
        self.stats = stats
        self.cfg = cfg
        self.lane = lane
        self.prefix = prefix
        self.h2d_bytes: List[int] = []
        self.d2h_bytes: List[int] = []
        self.h2d_s: List[float] = []
        self.d2h_s: List[float] = []

    def plan(self, queue, active, lanes, round_of, n_rounds: int,
             style: str):
        """Aggregate each instruction's horizontal traffic into the slice
        of the super-round it replays in: horizontal operands enter
        before that round (h2d), horizontal results drain after it (d2h);
        ``Ref``-forwarded / ``VerticalOperand`` inputs and
        ``keep_vertical`` outputs stay PuM-resident and move nothing."""
        h2d_raw = [0] * n_rounds
        d2h_raw = [0] * n_rounds
        for i in active:
            ins = queue[i]
            spec, _, _ = cached_table(ins.op, ins.n_bits, style)
            in_bits = [w for o, w in zip(ins.operands, spec.operand_bits)
                       if not isinstance(o, (Ref, VerticalOperand))]
            out_bits = [] if ins.keep_vertical else list(spec.out_bits)
            r = round_of[i]
            h2d_raw[r] += transfer_bytes_h2d(lanes[i], in_bits)
            d2h_raw[r] += transfer_bytes_d2h(lanes[i], out_bits)
        self.h2d_bytes = [burst_rounded_bytes(b, self.cfg) for b in h2d_raw]
        self.d2h_bytes = [burst_rounded_bytes(b, self.cfg) for b in d2h_raw]
        self.h2d_s = [h2d_transfer_s(b, self.cfg) for b in h2d_raw]
        self.d2h_s = [d2h_transfer_s(b, self.cfg) for b in d2h_raw]

    def _charge(self, direction: str, r: int, seconds: float, nbytes: int):
        """Charge one non-empty slice into the Stats accumulator and the
        matching telemetry category (zero-byte slices are skipped in
        both, keeping the left-fold reconciliation exact)."""
        if nbytes <= 0:
            return
        self.stats.transfer_bytes += nbytes
        if direction == "h2d":
            self.stats.transfer_h2d_s += seconds
        else:
            self.stats.transfer_d2h_s += seconds
        tr = active_tracer()
        if tr is not None:
            cat = f"{self.prefix}.transfer.{direction}"
            ev = tr.event(cat, cat="transfer", lane=self.lane,
                          round=r, bytes=nbytes)
            tr.charge(cat, seconds, span=ev)

    def after_round(self, r: int, round_s: float):
        """Account the DMA slot that ran alongside replay of super-round
        ``r``: stream in round ``r+1``'s inputs, drain round ``r−1``'s
        outputs, plus the fill prologue (``r == 0``) and drain epilogue
        (``r == n−1``) which are fully exposed."""
        n = len(self.h2d_s)
        if r == 0:
            self._charge("h2d", 0, self.h2d_s[0], self.h2d_bytes[0])
        t_in = self.h2d_s[r + 1] if r + 1 < n else 0.0
        t_out = self.d2h_s[r - 1] if r >= 1 else 0.0
        if r + 1 < n:
            self._charge("h2d", r + 1, t_in, self.h2d_bytes[r + 1])
        if r >= 1:
            self._charge("d2h", r - 1, t_out, self.d2h_bytes[r - 1])
        if self.cfg.transfer_overlap:
            # exposed slack of this slot; by case analysis on the max,
            # hidden >= 0 and exposed <= t_in + t_out hold EXACTLY in
            # floating point
            exposed = max(round_s, t_in, t_out) - round_s
            hidden = (t_in + t_out) - exposed
            if hidden > 0.0:
                self.stats.transfer_overlapped_s += hidden
                tr = active_tracer()
                if tr is not None:
                    cat = f"{self.prefix}.transfer.overlapped"
                    ev = tr.event(cat, cat="transfer", lane=self.lane,
                                  round=r)
                    tr.charge(cat, hidden, span=ev)
        if r == n - 1:
            self._charge("d2h", n - 1, self.d2h_s[n - 1],
                         self.d2h_bytes[n - 1])


def _round_of(waves) -> Dict[int, int]:
    """Map each scheduled instruction to the super-round it replays in
    (``waves`` is the ``[chip][bank][round]`` wave plan)."""
    out: Dict[int, int] = {}
    for per_chip in waves:
        for per_bank in per_chip:
            for r, wave in enumerate(per_bank):
                for i in wave:
                    out[i] = r
    return out


def sequential_channel_dispatch(
    queue: Sequence[BbopInstr], n_chips: int = 2, n_banks: int = 4,
    n_subarrays: int = 2, cfg: DramConfig = DDR4, style: str = "mig",
    packing: str = "reorder", device="cuda",
):
    """The no-channel baseline: the *same* chip partition a
    :class:`SimdramChannel` would use, executed one chip at a time on
    separate :class:`~repro_torch.core.chip.SimdramChip` instances.

    Returns ``(results, chips)`` — results in queue order (the
    bit-exactness reference for channel dispatch), and the per-chip
    engines whose summed ``stats.latency_s`` is the serialized cost the
    channel's concurrent-chips model (max per super-round) improves on.
    """
    queue = list(queue)
    results: List = [None] * len(queue)
    chips = [SimdramChip(n_banks=n_banks, n_subarrays=n_subarrays, cfg=cfg,
                         style=style, packing=packing, device=device)
             for _ in range(n_chips)]
    if not queue:
        return results, chips
    lanes, _, _ = plan_queue(queue, style)
    active = [i for i in range(len(queue)) if lanes[i] > 0]
    for i in range(len(queue)):
        if lanes[i] == 0:
            results[i] = chips[0].banks[0]._empty_result(queue[i])
    chip_of = partition_queue(queue, active, lanes, n_chips, cfg, style)
    for c, chip in enumerate(chips):
        idxs = [i for i in active if chip_of[i] == c]
        if not idxs:
            continue
        for qi, out in zip(idxs, chip.dispatch(remap_sub_queue(queue, idxs))):
            results[qi] = out
    return results, chips


class SimdramChannel:
    """``n_chips`` chips × ``n_banks`` banks × ``n_subarrays`` subarrays,
    one stacked replay per super-round.

    All chips run the stacked-round engine unchanged; the channel stacks
    one chip round per chip into each super-round and replays it in one
    K5 launch on ``device``.  ``mesh``/``use_shard_map`` select the
    executor (:func:`repro_torch.distributed.pum.make_channel_executor`):
    a ``("channel", "data")`` mesh splits each super-round into chip ×
    bank slabs, one launch a slab on its position's device and stream.
    The member chips stay unsplit (``use_shard_map=False``).
    """

    def __init__(self, n_chips: int = 2, n_banks: int = 4,
                 n_subarrays: int = 2, cfg: DramConfig = DDR4,
                 style: str = "mig", fuse_ratio: int = 32,
                 packing: str = "reorder", mesh=None,
                 use_shard_map: Optional[bool] = None, fault=None,
                 device="cuda"):
        if n_chips < 1:
            raise ValueError("n_chips must be >= 1")
        from ..distributed.pum import (make_channel_executor,
                                       make_faulty_channel_executor)
        self.n_chips = n_chips
        self.n_banks = n_banks
        self.n_subarrays = n_subarrays
        self.cfg = cfg
        self.style = style
        self.device = resolve_device(device)
        self.fault = fault if (fault is not None and fault.enabled) else None
        # the member chips never submit their own replays here (the
        # channel stacks their packed rounds)
        self.chips = [
            SimdramChip(n_banks=n_banks, n_subarrays=n_subarrays, cfg=cfg,
                        style=style, fuse_ratio=fuse_ratio, packing=packing,
                        use_shard_map=False, fault=self.fault,
                        fault_seed=(c,), device=self.device)
            for c in range(n_chips)
        ]
        self.executor = make_channel_executor(
            n_chips, n_banks, mesh=mesh, use_shard_map=use_shard_map,
            device=self.device)
        self._faulty_executor = (
            make_faulty_channel_executor(n_chips, n_banks, mesh=mesh,
                                         use_shard_map=use_shard_map,
                                         device=self.device)
            if self.fault is not None else None)
        self.stats = ChannelStats(
            n_subarrays=n_chips * n_banks * n_subarrays,
            n_chips=n_chips, n_banks=n_banks)
        self._guard = DispatchGuard("SimdramChannel")
        self._lane = "channel"       # telemetry track label
        for c, chip in enumerate(self.chips):
            chip._lane = f"chip{c}"
            for b, bank in enumerate(chip.banks):
                bank._lane = f"chip{c}/bank{b}"

    # -- scheduling --------------------------------------------------------
    def _partition(self, queue, active, lanes) -> Dict[int, int]:
        """Chip assignment: Ref-connected components are indivisible
        (forwarded planes never cross chips), LPT bin-packed — the same
        rule the chip applies to banks one level down.  With fault
        injection, chips whose banks are all blacklisted drop out of the
        pool."""
        allowed = ([c for c in range(self.n_chips)
                    if any(b._wave_capacity > 0
                           for b in self.chips[c].banks)]
                   if self.fault is not None else None)
        return partition_queue(queue, active, lanes, self.n_chips,
                               self.cfg, self.style, allowed=allowed)

    def _schedule(self, queue, active, lanes, stage):
        """Build the ``[chip][bank][round]`` wave plan for one dispatch:
        Ref-connected chains bin-pack onto chips, then each chip's bank
        partitioner and wave schedulers take over unchanged.  Shared by
        channel dispatch and the rank tier (which calls it per member
        channel)."""
        chip_of = self._partition(queue, active, lanes)
        waves: List[List[List[List[int]]]] = []   # [chip][bank][round]
        for c, chip in enumerate(self.chips):
            idxs = [i for i in active if chip_of[i] == c]
            for i in idxs:
                chip.stats.bbops += 1
            bank_of = chip._partition(queue, idxs, lanes) if idxs else {}
            for i in idxs:
                chip.banks[bank_of[i]].stats.bbops += 1
            waves.append([
                chip.banks[b]._build_waves(
                    queue, [i for i in idxs if bank_of[i] == b], stage,
                    lanes)
                for b in range(self.n_banks)
            ])
        return chip_of, waves

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, queue: Sequence[BbopInstr], cancel=None) -> List:
        """Drain a bbop queue across all chips.

        Args:
            queue: sequence of :class:`~repro_torch.core.bank.BbopInstr`;
                ``Ref`` operands must point at earlier entries, and
                Ref-connected chains stay chip-local.

        Returns:
            One result per instruction, in queue order (same result
            forms as :meth:`repro_torch.core.chip.SimdramChip.dispatch`).

        Costs accumulate in :attr:`stats` (a :class:`ChannelStats`) and
        recursively in each chip's / bank's own stats.  Host packing of
        super-round *k+1* overlaps the replay of super-round *k*.

        With a :class:`~repro_torch.core.fault.FaultModel` attached, the
        queue replicates across spare lanes and every super-round replays
        under fault injection (one K6 launch per attempt) with
        majority-vote detection, bounded retry, and chip/bank/subarray
        blacklist-and-repack.  The replicated lanes also inflate
        ``transfer_bytes``: spare columns are real host↔chip traffic.

        ``cancel`` (optional zero-arg callable) is polled at super-round
        boundaries; concurrent calls on one engine raise
        ``RuntimeError``."""
        with self._guard:
            queue = list(queue)
            if self.fault is None or not queue:
                return self._dispatch_core(queue, cancel=cancel)
            from .fault import fault_guarded_dispatch
            return fault_guarded_dispatch(
                self.fault, self.stats.faults, queue,
                lambda q: self._dispatch_core(q, cancel=cancel),
                self._blacklist_units,
                lambda: sum(b._wave_capacity for chip in self.chips
                            for b in chip.banks),
                tier="channel",
                blacklist_snapshot=lambda: tuple(sorted(
                    (c, b, s) for c in range(self.n_chips)
                    for b in range(self.n_banks)
                    for s in self.chips[c].banks[b]._blacklist)))

    def _dispatch_core(self, queue: Sequence[BbopInstr],
                       cancel=None) -> List:
        queue = list(queue)
        results: List = [None] * len(queue)
        if not queue:
            return results           # clean no-op: stats stay zeroed
        tr = active_tracer()
        root = (tr.begin("channel.dispatch", cat="dispatch",
                         lane=self._lane, instrs=len(queue))
                if tr is not None else None)
        t0 = time.perf_counter()
        self.stats.bbops += len(queue)
        with span_or_null(tr, "channel.plan", cat="plan"):
            lanes, stage, needed = plan_queue(queue, self.style)
        planes_cache: Dict[Tuple[int, int], np.ndarray] = {}
        active = []
        for i in range(len(queue)):
            if lanes[i] == 0:
                self.chips[0].banks[0]._skip_zero_lane(
                    queue, i, needed, planes_cache, results)
            else:
                active.append(i)
        if not active:               # all-zero-lane queue: no replay
            self.stats.wall_s += time.perf_counter() - t0
            if root is not None:
                tr.end(root)
            return results

        sp = (tr.begin("channel.schedule", cat="plan")
              if tr is not None else None)
        chip_of, waves = self._schedule(queue, active, lanes, stage)
        if sp is not None:
            tr.end(sp, chips=len(set(chip_of.values())))
        n_super = max(len(w) for per_chip in waves for w in per_chip)
        # DMA transfer schedule: inputs of super-round k+1 and outputs
        # of k-1 move while k replays; charged per completed slot below
        dma = _DmaSchedule(self.stats, self.cfg, self._lane, "channel")
        dma.plan(queue, active, lanes, _round_of(waves), n_super,
                 self.style)
        pending = None               # (chips_entries, states, event)
        for r in range(n_super):
            check_cancel(cancel, "channel super-round boundary")
            round_by_chip = []
            for c in range(self.n_chips):
                rw = [(b, waves[c][b][r]) for b in range(self.n_banks)
                      if r < len(waves[c][b])]
                if rw:
                    round_by_chip.append((c, rw))
            if pending is not None:
                # stage barrier: a super-round forwarding planes from
                # the still-in-flight one drains it before packing
                in_flight = {e.qi for _, ebb in pending[0]
                             for _, ents in ebb for e in ents}
                if any(isinstance(o, Ref) and o.producer in in_flight
                       for _, rw in round_by_chip
                       for _, wave in rw
                       for i in wave for o in queue[i].operands):
                    self._harvest_super_round(queue, pending, planes_cache,
                                              needed, results)
                    pending = None
            chips_entries, fut = self._pack_super_round(
                queue, round_by_chip, lanes, planes_cache)
            round_s = self._account_super_round(queue, chips_entries)
            dma.after_round(r, round_s)
            if pending is not None:
                # double buffering: super-round k harvests only after
                # super-round k+1 was packed and submitted
                self._harvest_super_round(queue, pending, planes_cache,
                                          needed, results)
            pending = (chips_entries, *fut)
        if pending is not None:
            with span_or_null(tr, "channel.drain", cat="drain"):
                wait_stacked(pending[-1])      # drain the pipeline
            self._harvest_super_round(queue, pending, planes_cache, needed,
                                      results)
        self.stats.wall_s += time.perf_counter() - t0
        if root is not None:
            tr.end(root)
        return results

    def _pack_super_round(self, queue, round_by_chip, lanes, planes_cache):
        """Stack one chip round per participating chip into the channel
        arrays and submit the super-round.

        Every chip's slab is padded to the super-round's max (rows, cmds,
        cols) — NOP commands and zero rows are inert — so one launch
        replays all chips; idle chips stay all-NOP.  The super-round's
        tables, flattened to one unit axis with their schedule, come from
        :data:`~repro_torch.core.control_unit.TABLE_CACHE`, keyed by the
        whole super-round's composition.  Returns ``(chips_entries,
        (states, event))``."""
        tr = active_tracer()
        t_pack = time.perf_counter()
        sp = (tr.begin("channel.pack_super_round", cat="pack",
                       chips=len(round_by_chip))
              if tr is not None else None)
        n_rows, n_cmds, cols = self._super_round_dims(queue, round_by_chip,
                                                      lanes)
        states, chip_keys, chips_entries = self._pack_super_round_states(
            queue, round_by_chip, lanes, planes_cache, n_rows, n_cmds, cols)
        tables = TABLE_CACHE.get(
            ("channel", self.n_chips, self.n_banks, self.n_subarrays,
             n_cmds, tuple(chip_keys), str(self.device)),
            lambda: self._build_super_round_tables(chip_keys, n_cmds)
            .reshape(-1, n_cmds, CMD_WIDTH),
            self.device)
        if sp is not None:
            tr.end(sp)
        pack_s = time.perf_counter() - t_pack
        self.stats.pack_wall_s += pack_s
        for c, _ in round_by_chip:
            self.chips[c].stats.pack_wall_s += pack_s / len(round_by_chip)
        with span_or_null(tr, "channel.replay", cat="replay",
                          chips=len(round_by_chip)):
            fut = self._submit_super_round(states, tables, chips_entries)
        return chips_entries, fut

    def _super_round_dims(self, queue, round_by_chip, lanes):
        """Max (rows, cmds, cols) over the participating chips' rounds —
        the shared slab dims one stacked replay pads every chip to.  The
        rank tier maxes this once more across its channels."""
        dims = [self.chips[c]._round_dims(queue, rw, lanes)
                for c, rw in round_by_chip]
        return (max(d[0] for d in dims), max(d[1] for d in dims),
                max(d[2] for d in dims))

    def _pack_super_round_states(self, queue, round_by_chip, lanes,
                                 planes_cache, n_rows, n_cmds, cols):
        """Pack one super-round's chip slabs at the given shared dims;
        returns ``(states, chip_keys, chips_entries)``.  Transpose-side
        savings each chip records while packing mirror into this
        channel's stats (the rank tier re-mirrors them one level up)."""
        states = np.zeros(
            (self.n_chips, self.n_banks, self.n_subarrays, n_rows,
             cols // 32), np.uint32)
        chips_entries: List[Tuple[int, List[Tuple[int, List[_Slot]]]]] = []
        chip_keys: List = [None] * self.n_chips
        tr = active_tracer()
        for c, rw in round_by_chip:
            chip = self.chips[c]
            sp_c = (tr.begin("chip.pack_round", cat="pack",
                             lane=chip._lane, banks=len(rw))
                    if tr is not None else None)
            snap = [getattr(chip.stats, f) for f in _TRANSPOSE]
            st, bank_keys, entries_by_bank = chip._pack_round_states(
                queue, rw, lanes, planes_cache, n_rows, n_cmds, cols)
            if sp_c is not None:
                tr.end(sp_c)
            _mirror(self.stats, chip.stats, _TRANSPOSE, snap)
            states[c] = st
            chip_keys[c] = tuple(bank_keys)
            chips_entries.append((c, entries_by_bank))
        return states, chip_keys, chips_entries

    def _submit_super_round(self, states, tables, chips_entries):
        """Submit one stacked super-round; returns ``(states, event)``.
        Fault-free: one K5 launch and the copy back behind it.
        Fault-injected: the synchronous detect/retry/heal loop over the
        channel-tier faulty executor (one K6 launch per attempt); its
        healed host states need no event."""
        if self.fault is None:
            return submit_stacked(self.executor.run, states, tables)
        from .fault import faulty_execute
        slabs = [((c, b), entries, self.chips[c].banks[b]._fault_rt)
                 for c, entries_by_bank in chips_entries
                 for b, entries in entries_by_bank]
        return faulty_execute(
            self.fault, self._faulty_executor.run, states, tables,
            slabs, self.stats.faults, self.cfg), None

    def _blacklist_units(self, units) -> int:
        """Retire persistently-failing subarrays (``units`` are
        ``(chip, bank, sid)`` tuples); returns how many are newly
        blacklisted."""
        new = 0
        for u in units:
            c, b, sid = int(u[-3]), int(u[-2]), int(u[-1])
            bl = self.chips[c].banks[b]._blacklist
            if sid not in bl:
                bl.add(sid)
                new += 1
        return new

    def _build_super_round_tables(self, chip_keys, n_cmds: int) -> np.ndarray:
        """Materialize one super-round's stacked (n_chips, n_banks,
        n_subarrays, n_cmds, 13) tables (the table cache's build
        function — runs once per distinct composition)."""
        out = np.zeros(
            (self.n_chips, self.n_banks, self.n_subarrays, n_cmds,
             CMD_WIDTH), np.int32)
        for c, keys in enumerate(chip_keys):
            if keys is None:
                continue
            out[c] = self.chips[c]._build_round_tables(list(keys), n_cmds)
        return out

    def _account_super_round(self, queue, chips_entries):
        """Charge one super-round: each chip's round accounts on the chip
        (and its banks) via the unchanged chip-level rule, while the
        channel charges the super-round at
        :func:`repro_torch.core.timing.channel_round_latency_s` — the max
        across concurrently-replaying chips, priced from the same
        ``bank_waves`` the chip rule used.  Returns the super-round's
        modeled latency so the caller can schedule the DMA slot (or, at
        the rank tier, take the max across channels) against it."""
        st = self.stats
        st.super_rounds += 1
        per_chip = self.n_banks * self.n_subarrays
        chip_rounds = []
        for c, entries_by_bank in chips_entries:
            chip = self.chips[c]
            snap = [getattr(chip.stats, f) for f in _MIRROR]
            lat0 = chip.stats.latency_s
            progs0 = chip.stats.subarray_programs.copy()
            bank_waves = chip._account_round(queue, entries_by_bank)
            _mirror(st, chip.stats, _MIRROR, snap)
            st.chip_busy_s[c] += chip.stats.latency_s - lat0
            tr = active_tracer()
            if tr is not None:
                # per-chip modeled busy time on the chip's own lane (the
                # super-round charges the max across chips)
                ev = tr.event("chip.round", cat="replay", lane=chip._lane)
                tr.charge("chip.busy", chip.stats.latency_s - lat0, span=ev)
            st.subarray_programs[c * per_chip:(c + 1) * per_chip] += (
                chip.stats.subarray_programs - progs0)
            chip_rounds.append(bank_waves)
        round_s = channel_round_latency_s(chip_rounds, self.cfg)
        st.latency_s += round_s
        tr = active_tracer()
        if tr is not None:
            tr.charge("channel.replay", round_s)
        return round_s

    def _harvest_super_round(self, queue, pending, planes_cache, needed,
                             results):
        """Materialize one completed super-round (waiting for its states
        to arrive on the host)."""
        chips_entries, fut, done = pending
        with span_or_null(active_tracer(), "channel.unpack", cat="unpack"):
            self._harvest_super_round_out(queue, chips_entries,
                                          drain_stacked(fut, done),
                                          planes_cache, needed, results)

    def _harvest_super_round_out(self, queue, chips_entries, out,
                                 planes_cache, needed, results):
        """Harvest an executed (n_chips, n_banks, n_subarrays, n_rows,
        n_words) host array, chip slab by chip slab (forwarded planes
        publish per chip — chains are chip-local)."""
        for c, entries_by_bank in chips_entries:
            chip = self.chips[c]
            snap = [getattr(chip.stats, f) for f in _TRANSPOSE]
            chip._harvest_round_out(queue, entries_by_bank, out[c],
                                    planes_cache, needed, results)
            _mirror(self.stats, chip.stats, _TRANSPOSE, snap)

    # -- ISA front-end -----------------------------------------------------
    def bbop(self, name: str, *operands, n_bits: int,
             signed_out: bool = False):
        """One bbop whose lanes span the whole channel: elements split
        into contiguous chunks, one per (chip, bank, subarray) slot, and
        drain in (ideally) one super-round."""
        return spread_bbop(self,
                           self.n_chips * self.n_banks * self.n_subarrays,
                           name, operands, n_bits, signed_out)

    def reset_stats(self):
        self.stats = ChannelStats(
            n_subarrays=self.n_chips * self.n_banks * self.n_subarrays,
            n_chips=self.n_chips, n_banks=self.n_banks)
        for chip in self.chips:
            chip.reset_stats()
