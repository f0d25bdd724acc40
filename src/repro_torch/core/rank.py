"""Rank-level partitioned execution: L channels × N chips × M banks × K
subarrays — the ladder's rung above :mod:`repro_torch.core.channel`.

Counterpart of :mod:`repro.core.rank`, with the reference's tracer
calls (``rank.*`` spans, the ``rank.transfer.*`` charges of the shared
host link, and ``channel.round`` events charging each member channel's
``channel.busy``; a member channel never charges the link).  A DRAM rank groups several memory
channels behind one host link.  Channels share nothing compute-side, so
the rank tier follows the discipline of every rung below it:

  - a :class:`SimdramRank` owns ``n_channels``
    :class:`~repro_torch.core.channel.SimdramChannel` instances and stacks
    their per-round slabs into one ``(n_channels, n_chips, n_banks,
    n_subarrays, n_rows, n_words)`` array — one *rank round* replays
    every channel's super-round in a single K5 launch over all its units
    (:func:`repro_torch.core.control_unit.rank_replay`), or one a slab of
    a device mesh;
  - :meth:`SimdramRank.dispatch` bin-packs Ref-connected chains onto
    channels (chains stay channel-local), then each channel's chip/bank
    partitioners and wave schedulers take over unchanged;
  - the host link is shared by the WHOLE rank, so the DMA transfer model
    is accounted once at this tier
    (:class:`repro_torch.core.channel._DmaSchedule`).

Fault injection is not supported at this tier, as in the reference
(construct faulty :class:`~repro_torch.core.channel.SimdramChannel`
engines instead).

Bit-exactness: rank dispatch == sequential per-channel
``SimdramChannel.dispatch`` == the reference's rank dispatch
(tests/test_torch_rank.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import resolve_device
from .bank import (BbopInstr, Ref, _Slot, drain_stacked, plan_queue,
                   submit_stacked, wait_stacked)
from .channel import (_MIRROR, _TRANSPOSE, ChannelStats, SimdramChannel,
                      _DmaSchedule, _mirror, _round_of)
from .chip import partition_queue, remap_sub_queue, spread_bbop
from .control_unit import CMD_WIDTH, TABLE_CACHE
from .isa import DispatchGuard, check_cancel
from .telemetry import active_tracer, span_or_null
from .timing import DDR4, DramConfig


@dataclass
class RankStats(ChannelStats):
    """Aggregate cost model for everything a :class:`SimdramRank` ran.

    Inherited fields aggregate over ALL channels: ``n_chips`` is the
    rank-wide chip total (``n_channels × chips-per-channel``), so the
    inherited per-chip surfaces keep working over the flattened
    channel-major chip list.  ``super_rounds`` counts *rank* rounds (one
    stacked replay each); ``latency_s`` charges each round's slowest
    channel — channels replay concurrently.  The DMA transfer model
    accumulates here (the host link is shared by the whole rank).
    """

    n_channels: int = 1
    channel_busy_s: np.ndarray = field(default=None)  # type: ignore

    # rank-tier additions to the inherited ChannelStats spec
    _FIELD_SPEC = (
        ("n_channels", "int"),
        ("channel_busy_s", "float_list"),
        ("channel_programs", "int_list"),
        ("channel_imbalance", "float"),
    )

    def __post_init__(self):
        super().__post_init__()
        if self.channel_busy_s is None:
            self.channel_busy_s = np.zeros(self.n_channels)

    @property
    def channel_programs(self) -> np.ndarray:
        """Instructions executed per channel (the scheduler's balance)."""
        return self.subarray_programs.reshape(
            self.n_channels, -1).sum(axis=1)

    @property
    def channel_imbalance(self) -> float:
        """Slowest channel's busy time over the mean — 1.0 is a
        perfectly balanced schedule, ``n_channels`` is all work on one
        channel."""
        if not self.channel_busy_s.any():
            return 0.0
        return float(self.channel_busy_s.max() / self.channel_busy_s.mean())


def sequential_rank_dispatch(
    queue: Sequence[BbopInstr], n_channels: int = 2, n_chips: int = 2,
    n_banks: int = 2, n_subarrays: int = 2, cfg: DramConfig = DDR4,
    style: str = "mig", packing: str = "reorder", device="cuda",
):
    """The no-rank baseline: the *same* channel partition a
    :class:`SimdramRank` would use, executed one channel at a time on
    separate :class:`~repro_torch.core.channel.SimdramChannel` instances.

    Returns ``(results, channels)`` — results in queue order (the
    bit-exactness reference for rank dispatch), and the per-channel
    engines whose summed ``stats.latency_s`` is the serialized cost the
    rank's concurrent-channels model (max per rank round) improves on.
    """
    queue = list(queue)
    results: List = [None] * len(queue)
    channels = [SimdramChannel(n_chips=n_chips, n_banks=n_banks,
                               n_subarrays=n_subarrays, cfg=cfg,
                               style=style, packing=packing, device=device)
                for _ in range(n_channels)]
    if not queue:
        return results, channels
    lanes, _, _ = plan_queue(queue, style)
    active = [i for i in range(len(queue)) if lanes[i] > 0]
    for i in range(len(queue)):
        if lanes[i] == 0:
            results[i] = channels[0].chips[0].banks[0]._empty_result(
                queue[i])
    channel_of = partition_queue(queue, active, lanes, n_channels, cfg,
                                 style)
    for k, ch in enumerate(channels):
        idxs = [i for i in active if channel_of[i] == k]
        if not idxs:
            continue
        for qi, out in zip(idxs, ch.dispatch(remap_sub_queue(queue, idxs))):
            results[qi] = out
    return results, channels


class SimdramRank:
    """``n_channels`` channels × ``n_chips`` chips × ``n_banks`` banks ×
    ``n_subarrays`` subarrays, one stacked replay per rank round.

    All channels run the stacked super-round engine unchanged; the rank
    stacks one channel super-round per channel into each rank round and
    replays it in one K5 launch on ``device``.  ``mesh``/``use_shard_map``
    select the executor
    (:func:`repro_torch.distributed.pum.make_rank_executor`): a ``("rank",
    "channel", "data")`` mesh splits each rank round into channel × chip
    × bank slabs, one launch a slab on its position's device and stream.
    The member channels stay unsplit (``use_shard_map=False``).
    """

    def __init__(self, n_channels: int = 2, n_chips: int = 2,
                 n_banks: int = 2, n_subarrays: int = 2,
                 cfg: DramConfig = DDR4, style: str = "mig",
                 fuse_ratio: int = 32, packing: str = "reorder",
                 mesh=None, use_shard_map: Optional[bool] = None,
                 device="cuda"):
        if n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        from ..distributed.pum import make_rank_executor
        self.n_channels = n_channels
        self.n_chips = n_chips               # per channel
        self.n_banks = n_banks               # per chip
        self.n_subarrays = n_subarrays       # per bank
        self.cfg = cfg
        self.style = style
        self.device = resolve_device(device)
        # member channels never submit their own replays (the rank
        # stacks their packed super-rounds)
        self.channels = [
            SimdramChannel(n_chips=n_chips, n_banks=n_banks,
                           n_subarrays=n_subarrays, cfg=cfg, style=style,
                           fuse_ratio=fuse_ratio, packing=packing,
                           use_shard_map=False, device=self.device)
            for _ in range(n_channels)
        ]
        self.executor = make_rank_executor(
            n_channels, n_chips, n_banks, mesh=mesh,
            use_shard_map=use_shard_map, device=self.device)
        self.stats = RankStats(
            n_subarrays=n_channels * n_chips * n_banks * n_subarrays,
            n_chips=n_channels * n_chips, n_banks=n_banks,
            n_channels=n_channels)
        self._guard = DispatchGuard("SimdramRank")
        self._lane = "rank"          # telemetry track label
        for k, ch in enumerate(self.channels):
            ch._lane = f"channel{k}"
            for c, chip in enumerate(ch.chips):
                chip._lane = f"channel{k}/chip{c}"
                for b, bank in enumerate(chip.banks):
                    bank._lane = f"channel{k}/chip{c}/bank{b}"

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, queue: Sequence[BbopInstr], cancel=None) -> List:
        """Drain a bbop queue across all channels.

        Ref-connected chains stay channel-local.  Costs accumulate in
        :attr:`stats` (a :class:`RankStats`) and recursively in each
        channel's / chip's / bank's own stats; host packing of rank round
        *k+1* overlaps the replay of round *k*, and the DMA schedule
        streams round *k+1*'s inputs / drains round *k−1*'s outputs
        alongside replay of *k*.

        ``cancel`` (optional zero-arg callable) is polled at rank-round
        boundaries; concurrent calls on one engine raise
        ``RuntimeError``."""
        with self._guard:
            return self._dispatch_core(list(queue), cancel=cancel)

    def _dispatch_core(self, queue: Sequence[BbopInstr],
                       cancel=None) -> List:
        results: List = [None] * len(queue)
        if not queue:
            return results           # clean no-op: stats stay zeroed
        tr = active_tracer()
        root = (tr.begin("rank.dispatch", cat="dispatch",
                         lane=self._lane, instrs=len(queue))
                if tr is not None else None)
        t0 = time.perf_counter()
        self.stats.bbops += len(queue)
        with span_or_null(tr, "rank.plan", cat="plan"):
            lanes, stage, needed = plan_queue(queue, self.style)
        planes_cache: Dict[Tuple[int, int], np.ndarray] = {}
        active = []
        for i in range(len(queue)):
            if lanes[i] == 0:
                self.channels[0].chips[0].banks[0]._skip_zero_lane(
                    queue, i, needed, planes_cache, results)
            else:
                active.append(i)
        if not active:               # all-zero-lane queue: no replay
            self.stats.wall_s += time.perf_counter() - t0
            if root is not None:
                tr.end(root)
            return results

        sp = (tr.begin("rank.schedule", cat="plan")
              if tr is not None else None)
        channel_of = partition_queue(queue, active, lanes, self.n_channels,
                                     self.cfg, self.style)
        waves_by_channel = []        # [channel][chip][bank][round]
        round_of: Dict[int, int] = {}
        for k, ch in enumerate(self.channels):
            idxs = [i for i in active if channel_of[i] == k]
            for i in idxs:
                ch.stats.bbops += 1
            _, waves = ch._schedule(queue, idxs, lanes, stage)
            waves_by_channel.append(waves)
            round_of.update(_round_of(waves))
        if sp is not None:
            tr.end(sp, channels=len(set(channel_of.values())))
        n_rank = max(len(w) for per_ch in waves_by_channel
                     for per_chip in per_ch for w in per_chip)
        # DMA transfer schedule over the rank-shared host link: inputs
        # of rank round k+1 and outputs of k-1 move while k replays
        dma = _DmaSchedule(self.stats, self.cfg, self._lane, "rank")
        dma.plan(queue, active, lanes, round_of, n_rank, self.style)
        pending = None               # (channels_entries, states, event)
        for r in range(n_rank):
            check_cancel(cancel, "rank round boundary")
            round_by_channel = []
            for k in range(self.n_channels):
                round_by_chip = []
                for c in range(self.n_chips):
                    rw = [(b, waves_by_channel[k][c][b][r])
                          for b in range(self.n_banks)
                          if r < len(waves_by_channel[k][c][b])]
                    if rw:
                        round_by_chip.append((c, rw))
                if round_by_chip:
                    round_by_channel.append((k, round_by_chip))
            if pending is not None:
                # stage barrier: a rank round forwarding planes from
                # the still-in-flight one drains it before packing
                in_flight = {e.qi for _, centries in pending[0]
                             for _, ebb in centries
                             for _, ents in ebb for e in ents}
                if any(isinstance(o, Ref) and o.producer in in_flight
                       for _, rbc in round_by_channel
                       for _, rw in rbc
                       for _, wave in rw
                       for i in wave for o in queue[i].operands):
                    self._harvest_rank_round(queue, pending, planes_cache,
                                             needed, results)
                    pending = None
            channels_entries, fut = self._pack_rank_round(
                queue, round_by_channel, lanes, planes_cache)
            round_s = self._account_rank_round(queue, channels_entries)
            dma.after_round(r, round_s)
            if pending is not None:
                # double buffering: rank round k harvests only after
                # rank round k+1 was packed and submitted
                self._harvest_rank_round(queue, pending, planes_cache,
                                         needed, results)
            pending = (channels_entries, *fut)
        if pending is not None:
            with span_or_null(tr, "rank.drain", cat="drain"):
                wait_stacked(pending[-1])      # drain the pipeline
            self._harvest_rank_round(queue, pending, planes_cache, needed,
                                     results)
        self.stats.wall_s += time.perf_counter() - t0
        if root is not None:
            tr.end(root)
        return results

    def _pack_rank_round(self, queue, round_by_channel, lanes,
                         planes_cache):
        """Stack one channel super-round per participating channel into
        the rank arrays and submit the round.

        Every channel's slab is padded to the rank round's max (rows,
        cmds, cols) — NOP commands and zero rows are inert — so one
        launch replays all channels; idle channels stay all-NOP.  The
        round's tables, flattened to one unit axis with their schedule,
        come from :data:`~repro_torch.core.control_unit.TABLE_CACHE`,
        keyed by the whole rank round's composition.  Returns
        ``(channels_entries, (states, event))``."""
        tr = active_tracer()
        t_pack = time.perf_counter()
        sp = (tr.begin("rank.pack_round", cat="pack",
                       channels=len(round_by_channel))
              if tr is not None else None)
        dims = [self.channels[k]._super_round_dims(queue, rbc, lanes)
                for k, rbc in round_by_channel]
        n_rows = max(d[0] for d in dims)
        n_cmds = max(d[1] for d in dims)
        cols = max(d[2] for d in dims)
        states = np.zeros(
            (self.n_channels, self.n_chips, self.n_banks, self.n_subarrays,
             n_rows, cols // 32), np.uint32)
        channels_entries: List[
            Tuple[int, List[Tuple[int, List[Tuple[int, List[_Slot]]]]]]] = []
        channel_keys: List = [None] * self.n_channels
        for k, rbc in round_by_channel:
            ch = self.channels[k]
            snap = [getattr(ch.stats, f) for f in _TRANSPOSE]
            st, chip_keys, chips_entries = ch._pack_super_round_states(
                queue, rbc, lanes, planes_cache, n_rows, n_cmds, cols)
            _mirror(self.stats, ch.stats, _TRANSPOSE, snap)
            states[k] = st
            channel_keys[k] = tuple(chip_keys)
            channels_entries.append((k, chips_entries))
        tables = TABLE_CACHE.get(
            ("rank", self.n_channels, self.n_chips, self.n_banks,
             self.n_subarrays, n_cmds, tuple(channel_keys),
             str(self.device)),
            lambda: self._build_rank_round_tables(channel_keys, n_cmds)
            .reshape(-1, n_cmds, CMD_WIDTH),
            self.device)
        if sp is not None:
            tr.end(sp)
        pack_s = time.perf_counter() - t_pack
        self.stats.pack_wall_s += pack_s
        for k, _ in round_by_channel:
            self.channels[k].stats.pack_wall_s += (
                pack_s / len(round_by_channel))
        with span_or_null(tr, "rank.replay", cat="replay",
                          channels=len(round_by_channel)):
            fut = submit_stacked(self.executor.run, states, tables)
        return channels_entries, fut

    def _build_rank_round_tables(self, channel_keys, n_cmds: int
                                 ) -> np.ndarray:
        """Materialize one rank round's stacked (n_channels, n_chips,
        n_banks, n_subarrays, n_cmds, 13) tables (the table cache's
        build function — runs once per distinct composition)."""
        out = np.zeros(
            (self.n_channels, self.n_chips, self.n_banks, self.n_subarrays,
             n_cmds, CMD_WIDTH), np.int32)
        for k, keys in enumerate(channel_keys):
            if keys is None:
                continue
            out[k] = self.channels[k]._build_super_round_tables(
                list(keys), n_cmds)
        return out

    def _account_rank_round(self, queue, channels_entries) -> float:
        """Charge one rank round: each channel's super-round accounts on
        the channel (and its chips/banks) via the unchanged channel-level
        rule, while the rank charges the round at the max across
        concurrently-replaying channels.  Returns the round's modeled
        latency for the DMA schedule."""
        st = self.stats
        st.super_rounds += 1
        per_channel = self.n_chips * self.n_banks * self.n_subarrays
        round_s = 0.0
        for k, chips_entries in channels_entries:
            ch = self.channels[k]
            snap = [getattr(ch.stats, f) for f in _MIRROR]
            lat0 = ch.stats.latency_s
            busy0 = ch.stats.chip_busy_s.copy()
            progs0 = ch.stats.subarray_programs.copy()
            ch_round_s = ch._account_super_round(queue, chips_entries)
            _mirror(st, ch.stats, _MIRROR, snap)
            st.channel_busy_s[k] += ch.stats.latency_s - lat0
            st.chip_busy_s[k * self.n_chips:(k + 1) * self.n_chips] += (
                ch.stats.chip_busy_s - busy0)
            st.subarray_programs[k * per_channel:(k + 1) * per_channel] += (
                ch.stats.subarray_programs - progs0)
            tr = active_tracer()
            if tr is not None:
                # per-channel modeled busy time on the channel's own
                # lane (the rank round charges the max across channels)
                ev = tr.event("channel.round", cat="replay", lane=ch._lane)
                tr.charge("channel.busy", ch.stats.latency_s - lat0,
                          span=ev)
            round_s = max(round_s, ch_round_s)
        st.latency_s += round_s
        tr = active_tracer()
        if tr is not None:
            tr.charge("rank.replay", round_s)
        return round_s

    def _harvest_rank_round(self, queue, pending, planes_cache, needed,
                            results):
        """Materialize one completed rank round, channel slab by channel
        slab (forwarded planes publish per channel — chains are
        channel-local)."""
        channels_entries, fut, done = pending
        with span_or_null(active_tracer(), "rank.unpack", cat="unpack"):
            out = drain_stacked(fut, done)
            for k, chips_entries in channels_entries:
                ch = self.channels[k]
                snap = [getattr(ch.stats, f) for f in _TRANSPOSE]
                ch._harvest_super_round_out(queue, chips_entries, out[k],
                                            planes_cache, needed, results)
                _mirror(self.stats, ch.stats, _TRANSPOSE, snap)

    # -- ISA front-end -----------------------------------------------------
    def bbop(self, name: str, *operands, n_bits: int,
             signed_out: bool = False):
        """One bbop whose lanes span the whole rank: elements split into
        contiguous chunks, one per (channel, chip, bank, subarray) slot,
        and drain in (ideally) one rank round."""
        return spread_bbop(self, self.n_channels * self.n_chips
                           * self.n_banks * self.n_subarrays,
                           name, operands, n_bits, signed_out)

    def reset_stats(self):
        self.stats = RankStats(
            n_subarrays=(self.n_channels * self.n_chips * self.n_banks
                         * self.n_subarrays),
            n_chips=self.n_channels * self.n_chips, n_banks=self.n_banks,
            n_channels=self.n_channels)
        for ch in self.channels:
            ch.reset_stats()
