"""Bank-level batched μProgram execution engine (SIMDRAM's scaling layer).

Counterpart of :mod:`repro.core.bank`.  SIMDRAM's headline throughput
comes from parallel replay: the memory controller broadcasts one
μProgram command stream and every compute-enabled subarray (one per bank
in the paper's 1/4/16-bank sweeps) executes it simultaneously on its own
65 536 bit-columns.  Here:

  - a bank is a batched ``(n_subarrays, n_rows, n_words)`` state —
    subarray *s*'s D/B/C rows are slab ``states[s]``;
  - one launch of the replay kernel (K5) replays the shared command
    table on all slabs at once; programs stay data, so nothing is built
    per op;
  - :meth:`Bank.dispatch` is the ``bbop`` queue front-end, a fused
    dataflow dispatcher: per-subarray tables stack into one
    ``(n_subarrays, n_cmds, 13)`` tensor and a single
    :func:`~repro_torch.core.control_unit.hetero_batched_interpreter`
    replay executes different ops on different subarrays;
    producer→consumer chains (:class:`Ref` operands) forward intermediate
    results as bit-planes that never leave the vertical layout; host
    packing of wave *k+1* overlaps device replay of wave *k* (double
    buffering: the launch and the copy of its states back to pinned host
    memory are asynchronous, and wave *k* is read only after wave *k+1*
    was submitted); waves schedule with cross-stage
    reordering by default, and every wave's stacked command tables come
    from the device-resident :data:`~repro_torch.core.control_unit
    .TABLE_CACHE`.  Aggregate latency/energy/throughput are modeled with
    :mod:`repro_torch.core.timing` / :mod:`repro_torch.core.energy` — a
    fused wave charges the latency of its longest constituent μProgram,
    plus paid horizontal↔vertical conversions (``BankStats.transpose_s``).

Engines (all bit-exact):

  engine="interp"    command-table replay on K5 (default; models hardware)
  engine="bitplane"  fused bit-plane circuits, the subarray axis folded
                     into one K3 launch
  engine="cuda"      per-set h2v (K1) → K3 → v2h (K2), the counterpart of
                     the reference's ``"pallas"``

``Bank(fuse=False)`` keeps the per-(op, width, signedness) grouped replay
path — the baseline the fused dispatcher is tested against.  Host-side
packing stays numpy, as in the reference; tensors cross to the device
once per wave.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.build import resolve_device
from . import bitplane
from .control_unit import (CMD_WIDTH, TABLE_CACHE, CommandTables, SlabRound,
                           batched_interpreter,
                           encode_uprogram, faulty_batched_interpreter,
                           hetero_batched_interpreter, load_state,
                           output_plane_rows, pad_command_table,
                           read_outputs, shape_bucket, table_bucket)
from .costmodel import critical_path_s, forwarding_saving_s, instr_cost_s
from .energy import uprogram_energy_nj
from .fault import (FaultRuntime, FaultStats, fault_guarded_dispatch,
                    faulty_execute)
from .isa import DispatchGuard, _round_up, check_cancel, compile_op
from .telemetry import active_tracer, span_or_null, spec_as_dict
from .timing import DDR4, DramConfig, fused_replay_latency_s

ROW_BUCKET = 16     # state-row granularity shared across ops of one width


@functools.lru_cache(maxsize=512)
def cached_table(name: str, n_bits: int, style: str = "mig"):
    """μProgram-memory lookup: (spec, μProgram, encoded+bucketed table).

    The table is NOP-padded to its :func:`table_bucket` slot so distinct
    ops of similar size share one (n_cmds, 13) shape."""
    spec, uprog = compile_op(name, n_bits, style)
    raw = encode_uprogram(uprog)
    table = pad_command_table(raw, table_bucket(raw.shape[0]))
    return spec, uprog, table


def random_operand_sets(spec, n_sets: int, lanes: int, seed: int = 0):
    """Uniform random operand sets: one list of (lanes,) uint64 arrays per
    subarray, widths from ``spec.operand_bits``."""
    rng = np.random.default_rng(seed)
    return [
        [rng.integers(0, 1 << w, size=lanes).astype(np.uint64)
         for w in spec.operand_bits]
        for _ in range(n_sets)
    ]


@dataclass
class BankStats:
    """Aggregate cost model for everything a :class:`Bank` executed."""

    n_subarrays: int
    bbops: int = 0            # ISA instructions dispatched
    batches: int = 0          # batched replays (≤ bbops)
    fused_batches: int = 0    # replays mixing ≥2 distinct (op, width) tables
    transpositions_skipped: int = 0   # h2v/v2h conversions forwarding avoided
    transpose_s_saved: float = 0.0    # modeled seconds those skips saved
    transpose_s: float = 0.0          # modeled seconds of conversions PAID
    aap: int = 0              # per-subarray command counts, summed
    ap: int = 0
    elements: int = 0         # result elements produced
    latency_s: float = 0.0    # modeled wall-clock (subarrays concurrent)
    energy_nj: float = 0.0    # summed over all active subarrays
    pack_wall_s: float = 0.0  # measured host seconds spent packing waves
    wall_s: float = 0.0       # measured host seconds spent in dispatch()
    subarray_programs: np.ndarray = field(default=None)  # type: ignore
    faults: FaultStats = field(default_factory=FaultStats)

    def __post_init__(self):
        if self.subarray_programs is None:
            self.subarray_programs = np.zeros(self.n_subarrays, np.int64)

    def add_wave(self, cost, fused: bool, concurrent: bool = False):
        """Accumulate one wave's :class:`WaveCost`.  ``concurrent=True``
        skips ``latency_s`` (a tier that charges each round at the max
        across concurrently-replaying banks)."""
        self.batches += 1
        if fused:
            self.fused_batches += 1
        self.elements += cost.elements
        self.aap += cost.aap
        self.ap += cost.ap
        self.energy_nj += cost.energy_nj
        if not concurrent:
            self.latency_s += cost.latency_s

    # serialization spec consumed by spec_as_dict: the reference's keys,
    # in the reference's order
    _FIELD_SPEC = (
        ("n_subarrays", "int"),
        ("bbops", "int"),
        ("batches", "int"),
        ("fused_batches", "int"),
        ("transpositions_skipped", "int"),
        ("transpose_s_saved", "float"),
        ("transpose_s", "float"),
        ("total_latency_s", "float"),
        ("aap", "int"),
        ("ap", "int"),
        ("elements", "int"),
        ("latency_s", "float"),
        ("energy_nj", "float"),
        ("pack_wall_s", "float"),
        ("wall_s", "float"),
        ("throughput_gops", "float"),
        ("throughput_total_gops", "float"),
        ("faults", "stats_if_any"),
    )

    @property
    def throughput_gops(self) -> float:
        """Elements over *replay* latency only — the paper's headline
        figure, blind to transposition and fault overhead."""
        return self.elements / self.latency_s / 1e9 if self.latency_s else 0.0

    @property
    def throughput_total_gops(self) -> float:
        """Elements over :attr:`total_latency_s` — the end-to-end figure,
        paid transpositions included."""
        t = self.total_latency_s
        return self.elements / t / 1e9 if t else 0.0

    @property
    def total_latency_s(self) -> float:
        """Replay latency + the horizontal↔vertical conversions this path
        actually paid + the fault layer's redundant replays and vote reads
        (zero when injection is disabled) — the end-to-end modeled
        wall-clock."""
        return self.latency_s + self.transpose_s + self.faults.overhead_s

    def as_dict(self) -> Dict[str, float]:
        return spec_as_dict(self)


@dataclass(frozen=True)
class Ref:
    """Operand placeholder inside a dispatch queue: output ``out`` of
    ``queue[producer]`` feeds this instruction *vertically* — the
    producer's result bit-planes are copied straight from its executed
    state into the consumer's operand rows, skipping the v2h→h2v round
    trip the grouped path pays."""

    producer: int
    out: int = 0


@dataclass(frozen=True)
class VerticalOperand:
    """A vertical-layout (bit-plane) operand or result.

    ``planes[j]`` (host uint32) holds bit *j* of every lane, 32 lanes per
    word (lane *l* ↦ bit ``l % 32`` of word ``l // 32``).  Plane bits
    beyond ``lanes`` are unspecified; :meth:`to_values` truncates them.
    ``device`` is where the transposition unit runs for this operand: the
    K1/K2 kernels on ``"cuda"``, their plain versions on ``"cpu"``.
    """

    planes: np.ndarray
    lanes: int
    device: str = field(default="cuda", compare=False)

    @classmethod
    def from_values(cls, values, n_bits: int,
                    device="cuda") -> "VerticalOperand":
        """Pack horizontal integers through the transposition unit
        (:func:`repro_torch.kernels.ops.h2v`, K1, for widths ≤ 32)."""
        dev = resolve_device(device)
        vals = np.asarray(values)
        lanes = int(vals.shape[-1])
        if lanes == 0:
            return cls(np.zeros((n_bits, 0), np.uint32), 0, str(dev))
        if n_bits <= 32:
            t = torch.from_numpy(bitplane.host_i32(vals.reshape(-1))).to(dev)
            planes = kops.h2v(t, n_bits).cpu().numpy().view(np.uint32)
        else:
            from .subarray import pack_bits
            planes = pack_bits(vals.astype(np.uint64), n_bits,
                               _round_up(max(lanes, 1), 32))
        return cls(planes, lanes, str(dev))

    def to_values(self, signed: bool = False) -> np.ndarray:
        """Unpack through the transposition unit
        (:func:`repro_torch.kernels.ops.v2h`, K2, for widths ≤ 32) to
        (lanes,) int64."""
        n_bits = int(self.planes.shape[0])
        if self.lanes == 0:
            return np.zeros(0, np.int64)
        if n_bits <= 32:
            dev = resolve_device(self.device)
            planes = np.ascontiguousarray(self.planes, dtype=np.uint32)
            t = torch.from_numpy(planes.view(np.int32)).to(dev)
            vals = kops.v2h(t, signed=signed).cpu().numpy().astype(
                np.int64)[: self.lanes]
            if not signed and n_bits == 32:
                vals = vals & 0xFFFFFFFF
            return vals
        from .subarray import unpack_bits
        vals = unpack_bits(
            np.ascontiguousarray(self.planes), self.lanes).astype(np.int64)
        if signed and n_bits < 64:
            vals = np.where(vals >= (1 << (n_bits - 1)),
                            vals - (1 << n_bits), vals)
        return vals


Operand = Union[np.ndarray, VerticalOperand, Ref]


@dataclass(frozen=True)
class BbopInstr:
    """One queued ISA-level ``bbop``: op name + operands.

    Operands may be flat integer arrays (horizontal), pre-packed
    :class:`VerticalOperand` planes, or :class:`Ref` links to an earlier
    instruction's output.  ``keep_vertical=True`` returns the result(s)
    as :class:`VerticalOperand` (the v2h unpack is skipped)."""

    op: str
    operands: Tuple[Operand, ...]
    n_bits: int
    signed_out: bool = False
    keep_vertical: bool = False

    @property
    def elements(self) -> int:
        o = self.operands[0]
        if isinstance(o, VerticalOperand):
            return o.lanes
        if isinstance(o, Ref):
            raise ValueError(
                "lead operand is a Ref; lane count is resolved at dispatch")
        return int(np.asarray(o).shape[-1])


@dataclass
class _Slot:
    """One occupied subarray in a fused wave."""

    qi: int          # queue index
    sid: int         # subarray id
    spec: object
    uprog: object
    lanes: int


@dataclass(frozen=True)
class WaveCost:
    """Modeled cost of ONE fused-wave replay — the single place the
    per-slot serialization (lanes beyond the column capacity) and the
    longest-constituent latency rule are computed."""

    uprogs: Tuple
    invocations: Tuple[int, ...]
    elements: int
    aap: int
    ap: int
    energy_nj: float
    latency_s: float


def wave_cost(entries, cfg: DramConfig) -> WaveCost:
    """Cost one replay of ``entries`` = [(uprog, lanes, sid), ...].

    A physical subarray holds cfg.columns_per_subarray lanes; a slot
    wider than that serializes extra replays on its subarray (the
    simulation still runs them in one state — only the cost model
    quantizes).  Subarrays replay concurrently, so the wave's wall-clock
    is its longest constituent's serialized invocations."""
    cap = cfg.columns_per_subarray
    ups = tuple(e[0] for e in entries)
    invs = tuple(max(1, -(-e[1] // cap)) for e in entries)
    return WaveCost(
        uprogs=ups,
        invocations=invs,
        elements=sum(e[1] for e in entries),
        aap=sum(up.n_aap * i for up, i in zip(ups, invs)),
        ap=sum(up.n_ap * i for up, i in zip(ups, invs)),
        energy_nj=sum(uprogram_energy_nj(up, cfg) * i
                      for up, i in zip(ups, invs)),
        latency_s=fused_replay_latency_s(ups, invs, cfg),
    )


def flatten_result(result) -> List[np.ndarray]:
    """One horizontal array per output, :class:`VerticalOperand` results
    unpacked — the canonical form dispatch-path cross-checks compare in."""
    outs = result if isinstance(result, tuple) else (result,)
    return [o.to_values() if isinstance(o, VerticalOperand)
            else np.asarray(o) for o in outs]


def validate_queue(queue: Sequence[BbopInstr], style: str = "mig"):
    """Reject malformed queues with a clear :class:`ValueError` before
    anything reaches the replay: unknown op names, wrong operand counts,
    and horizontal operands that disagree on lane count (the
    vertical-operand and ``Ref`` checks live in :func:`plan_queue`, which
    calls this first).  Returns the queue unchanged."""
    for i, ins in enumerate(queue):
        try:
            spec, _, _ = cached_table(ins.op, ins.n_bits, style)
        except KeyError as e:
            raise ValueError(
                f"instr {i}: unknown op {ins.op!r} — see "
                "repro_torch.core.ops_library.ALL_OPS") from e
        if len(ins.operands) != spec.n_operands:
            raise ValueError(
                f"instr {i} ({ins.op}/{ins.n_bits}b): expects "
                f"{spec.n_operands} operands, got {len(ins.operands)}")
        horiz = {
            k: int(np.asarray(o).shape[-1])
            for k, o in enumerate(ins.operands)
            if not isinstance(o, (Ref, VerticalOperand))
        }
        if len(set(horiz.values())) > 1:
            raise ValueError(
                f"instr {i} ({ins.op}/{ins.n_bits}b): horizontal "
                f"operands disagree on lane count: "
                f"{{{', '.join(f'{k}: {n}' for k, n in horiz.items())}}}")
    return queue


def plan_queue(queue: Sequence[BbopInstr], style: str = "mig"):
    """Resolve a queue's dataflow: per-instruction lane counts, dependency
    stages (a consumer runs strictly after its producers), and the set of
    (producer, out) results needed vertically.

    Every vertical operand (Ref or VerticalOperand) must carry exactly
    the instruction's lane count: forwarded planes beyond the producer's
    lanes are unspecified bits, so a lane-mismatched forward is rejected
    here rather than silently diverging from the grouped path."""
    validate_queue(queue, style)
    n = len(queue)
    lanes, stage, needed = [0] * n, [0] * n, set()
    for i, ins in enumerate(queue):
        for o in ins.operands:
            if not isinstance(o, Ref):
                continue
            if not 0 <= o.producer < i:
                raise ValueError(
                    f"instr {i}: Ref producer {o.producer} must precede "
                    "it in the queue")
            pspec, _, _ = cached_table(
                queue[o.producer].op, queue[o.producer].n_bits, style)
            if not 0 <= o.out < len(pspec.out_bits):
                raise ValueError(
                    f"instr {i}: Ref output {o.out} out of range for "
                    f"{queue[o.producer].op}")
            needed.add((o.producer, o.out))
            stage[i] = max(stage[i], stage[o.producer] + 1)
        lead = ins.operands[0]
        if isinstance(lead, Ref):
            lanes[i] = lanes[lead.producer]
        elif isinstance(lead, VerticalOperand):
            lanes[i] = lead.lanes
        else:
            lanes[i] = int(np.asarray(lead).shape[-1])
        for k, o in enumerate(ins.operands):
            got = (lanes[o.producer] if isinstance(o, Ref)
                   else o.lanes if isinstance(o, VerticalOperand)
                   else None)
            if got is not None and got != lanes[i]:
                raise ValueError(
                    f"instr {i}: vertical operand {k} carries {got} "
                    f"lanes but the instruction has {lanes[i]}")
    return lanes, stage, needed


class Bank:
    """N concurrently-computing subarrays executing one command stream.

    ``n_subarrays`` models the paper's bank-level parallelism knob (the
    1/4/16-bank sweep uses one compute subarray per bank).  :meth:`bbop`
    spreads one large instruction's lanes across the bank,
    :meth:`dispatch` drains a queue of instructions.

    ``fuse_ratio`` bounds heterogeneous fusion: instructions join one
    wave only while the wave's largest/smallest bucketed command count
    and row count stay within the ratio.

    ``packing`` selects the wave scheduler: ``"reorder"`` (default) is
    cross-stage list scheduling prioritized by critical-path cost, kept
    only where the cost model prices it at or below ``"ffd"``, the
    stage-bucketed first-fit-decreasing packer; ``"greedy"`` closes one
    open wave as soon as an instruction does not fit.

    ``fault`` attaches a :class:`~repro_torch.core.fault.FaultModel`
    (``fault_seed`` namespaces its draws): dispatch then replicates lanes,
    injects faults in the K6 replay, votes, retries and blacklists (see
    :mod:`repro_torch.core.fault`).  A disabled model is dropped here and
    costs nothing.

    ``device`` (default ``"cuda"``) is where states and tables live.
    """

    def __init__(self, n_subarrays: int = 4, cfg: DramConfig = DDR4,
                 style: str = "mig", engine: str = "interp",
                 fuse: bool = True, fuse_ratio: int = 32,
                 packing: str = "reorder", fault=None,
                 fault_seed: Tuple[int, ...] = (), device="cuda"):
        if engine not in ("interp", "bitplane", "cuda"):
            raise ValueError(f"unknown engine {engine!r}")
        if fuse_ratio < 1:
            raise ValueError("fuse_ratio must be >= 1")
        if packing not in ("reorder", "ffd", "greedy"):
            raise ValueError(f"unknown packing {packing!r}")
        self.n_subarrays = n_subarrays
        self.cfg = cfg
        self.style = style
        self.engine = engine
        self.fuse = fuse
        self.fuse_ratio = fuse_ratio
        self.packing = packing
        self.fault = fault if (fault is not None and fault.enabled) else None
        self._blacklist: set = set()   # persistently-failing subarray ids
        if self.fault is not None:
            if not (engine == "interp" and fuse):
                raise ValueError(
                    "fault injection runs inside the fused interp replay; "
                    "use engine='interp', fuse=True")
            self._fault_rt = FaultRuntime(
                self.fault, tuple(fault_seed), n_subarrays)
        else:
            self._fault_rt = None
        self.device = resolve_device(device)
        self.stats = BankStats(n_subarrays)
        self._guard = DispatchGuard(type(self).__name__)
        self._rr_next = 0     # round-robin allocation cursor (grouped path)
        self._lane_load = np.zeros(n_subarrays, np.int64)  # fused-slot loads
        self._lane = "bank"   # telemetry track label; chip/channel relabel

    @property
    def _wave_capacity(self) -> int:
        """Subarrays a wave may still occupy: everything not blacklisted
        by the fault layer (all of them while injection is off)."""
        return self.n_subarrays - len(self._blacklist)

    # -- modeled-clock charges ---------------------------------------------
    # Each helper updates the Stats accumulator AND mirrors the identical
    # value into the active tracer's charge log in the same call, so the
    # tracer's left-fold per-category sum replays the Stats field's exact
    # FP addition order (bit-for-bit reconciliation).  With the tracer
    # disabled these collapse to the bare `+=`.

    def _pay_transpose(self, seconds: float) -> None:
        self.stats.transpose_s += seconds
        tr = active_tracer()
        if tr is not None:
            tr.charge("transpose", seconds)

    def _save_transpose(self, seconds: float, skipped: int = 1) -> None:
        self.stats.transpositions_skipped += skipped
        self.stats.transpose_s_saved += seconds
        tr = active_tracer()
        if tr is not None:
            tr.charge("transpose_saved", seconds)

    # -- core: one op, up to n_subarrays operand sets, one replay ----------
    def execute_batch(
        self,
        name: str,
        n_bits: int,
        operand_sets: Sequence[Sequence[np.ndarray]],
        signed_out: bool = False,
        subarray_ids: Optional[Sequence[int]] = None,
    ) -> List:
        """Execute ``name`` on each operand set, one set per subarray.

        All sets replay the *same* cached command table concurrently in
        one launch.  Returns one result per set (array, or tuple of
        arrays for multi-output ops)."""
        tr = active_tracer()
        with span_or_null(tr, "bank.execute_batch", cat="replay",
                          lane=self._lane, op=name, n_bits=n_bits,
                          sets=len(operand_sets)):
            return self._execute_batch(name, n_bits, operand_sets,
                                       signed_out, subarray_ids)

    def _execute_batch(self, name, n_bits, operand_sets, signed_out,
                       subarray_ids) -> List:
        if len(operand_sets) > self.n_subarrays:
            raise ValueError(
                f"{len(operand_sets)} operand sets > {self.n_subarrays} "
                "subarrays; chunk the batch (see dispatch())")
        if not operand_sets:
            return []
        spec, uprog, table = cached_table(name, n_bits, self.style)
        lanes = [int(np.asarray(ops[0]).shape[-1]) for ops in operand_sets]
        cols = _round_up(max(max(lanes), 1), 32)

        if self.engine == "interp":
            results = self._run_interp(
                spec, uprog, table, operand_sets, lanes, cols, signed_out)
        elif self.engine == "bitplane":
            results = self._run_bitplane(
                spec, name, n_bits, operand_sets, lanes, cols, signed_out)
        else:
            results = self._run_cuda(name, n_bits, operand_sets, signed_out)

        # every operand enters horizontally (h2v) and every output
        # leaves horizontally (v2h) on this path — charge the
        # transposition unit for each conversion
        for n in lanes:
            for w in (*spec.operand_bits, *spec.out_bits):
                self._pay_transpose(forwarding_saving_s(n, w, self.cfg))
        self._account(uprog, operand_sets, lanes, subarray_ids)
        return results

    # -- engines -----------------------------------------------------------
    def _run_interp(self, spec, uprog, table, operand_sets, lanes, cols,
                    signed_out):
        # always stack the full bank: a partial batch replays on all
        # subarrays (the controller broadcasts regardless)
        n_rows = _round_up(uprog.n_rows_total, ROW_BUCKET)
        states = np.zeros((self.n_subarrays, n_rows, cols // 32), np.uint32)
        for s, operands in enumerate(operand_sets):
            load_state(uprog, operands, cols, n_rows=n_rows, out=states[s])
        run = batched_interpreter(self.device)
        out = run(states, table).cpu().numpy().view(np.uint32)
        results = []
        for s in range(len(operand_sets)):
            outs = read_outputs(
                spec.out_bits, uprog, out[s], lanes[s], signed_out)
            results.append(outs[0] if len(outs) == 1 else tuple(outs))
        return results

    def _run_bitplane(self, spec, name, n_bits, operand_sets, lanes, cols,
                      signed_out):
        packed = []     # one (n_sets, width_i, cols//32) stack per operand
        for op_idx, w in enumerate(spec.operand_bits):
            vals = np.zeros((len(operand_sets), cols), np.int64)
            for s, operands in enumerate(operand_sets):
                v = np.asarray(operands[op_idx]).astype(np.int64)
                vals[s, : v.shape[-1]] = v
            packed.append(bitplane.pack(
                torch.from_numpy(vals).to(self.device), w))
        outs = bitplane.op_on_planes_batch(name, n_bits, *packed)
        outs = [bitplane.unpack(o, signed=signed_out).cpu().numpy()
                for o in outs]
        results = []
        for s in range(len(operand_sets)):
            per = [o[s].astype(np.int64)[: lanes[s]] for o in outs]
            results.append(per[0] if len(per) == 1 else tuple(per))
        return results

    def _run_cuda(self, name, n_bits, operand_sets, signed_out):
        return [kops.to_host(kops.bbop_cuda(
                    name, n_bits, *[np.asarray(o) for o in operands],
                    signed_out=signed_out, device=self.device))
                for operands in operand_sets]

    # -- cost accounting ---------------------------------------------------
    def _account(self, uprog, operand_sets, lanes, subarray_ids):
        k = len(operand_sets)
        if subarray_ids is None:
            subarray_ids = range(k)
        c = self._account_wave(
            [(uprog, n, sid) for n, sid in zip(lanes, subarray_ids)],
            fused=False)
        tr = active_tracer()
        if tr is not None:
            tr.charge("bank.replay", c.latency_s)

    def _account_wave(self, entries, fused: bool) -> WaveCost:
        """Charge one replay of ``entries`` = [(uprog, lanes, sid), ...]
        at the :func:`wave_cost` price; returns the cost."""
        c = wave_cost(entries, self.cfg)
        self.stats.add_wave(c, fused)
        for _, _, sid in entries:
            self.stats.subarray_programs[sid % self.n_subarrays] += 1
        return c

    # -- ISA front-ends ----------------------------------------------------
    def bbop(self, name: str, *operands, n_bits: int,
             signed_out: bool = False):
        """One bbop whose lanes span the whole bank: elements are split
        into contiguous per-subarray chunks and executed in one replay."""
        self.stats.bbops += 1
        arrs = [np.asarray(o) for o in operands]
        n = arrs[0].shape[-1]
        if n == 0:
            spec, _, _ = cached_table(name, n_bits, self.style)
            outs = [np.zeros(0, np.int64) for _ in spec.out_bits]
            return outs[0] if len(outs) == 1 else tuple(outs)
        per = max(1, -(-n // self.n_subarrays))
        sets = [
            [a[..., s: s + per] for a in arrs] for s in range(0, n, per)
        ]
        results = self.execute_batch(name, n_bits, sets, signed_out)
        if isinstance(results[0], tuple):
            return tuple(np.concatenate([r[i] for r in results], axis=-1)
                         for i in range(len(results[0])))
        return np.concatenate(results, axis=-1)

    def dispatch(self, queue: Sequence[BbopInstr], cancel=None) -> List:
        """Drain a queue of bbops; results come back in queue order and
        costs accumulate in :attr:`stats`.

        With ``fuse=True`` on the ``interp`` engine (the default), the
        queue compiles to a sequence of *waves*: up to ``n_subarrays``
        instructions — different ops, widths, and signedness — stack
        their command tables and replay in ONE fused K5 launch; ``Ref``
        operands forward producer bit-planes without leaving the vertical
        layout; host packing of wave *k+1* overlaps device replay of wave
        *k*.  Otherwise instructions with the same (op, width,
        signedness) are allocated round-robin across subarrays and each
        full batch replays its cached command table once (the grouped
        baseline).

        With a :class:`~repro_torch.core.fault.FaultModel` attached, the
        queue first replicates every lane across the spare columns, then
        drains through the same fused path on the fault-injected replay
        (K6) — detection, bounded retry, blacklist-and-repack, and
        finally :class:`~repro_torch.core.fault.FaultExhaustedError` when
        the redundancy budget runs out.

        ``cancel`` (optional zero-arg callable) is polled at wave
        boundaries; returning True aborts with
        :class:`~repro_torch.core.isa.DispatchCancelled`.  Concurrent
        calls on one engine raise ``RuntimeError``."""
        with self._guard:
            queue = list(queue)
            if self.fault is None or not queue:
                return self._dispatch_core(queue, cancel=cancel)
            return fault_guarded_dispatch(
                self.fault, self.stats.faults, queue,
                lambda q: self._dispatch_core(q, cancel=cancel),
                self._blacklist_units, lambda: self._wave_capacity,
                tier="bank",
                blacklist_snapshot=lambda: tuple(
                    (s,) for s in sorted(self._blacklist)))

    def _dispatch_core(self, queue: Sequence[BbopInstr],
                       cancel=None) -> List:
        queue = list(queue)
        results: List = [None] * len(queue)
        if not queue:
            return results           # clean no-op: stats stay zeroed
        tr = active_tracer()
        root = (tr.begin("bank.dispatch", cat="dispatch", lane=self._lane,
                         instrs=len(queue)) if tr is not None else None)
        t0 = time.perf_counter()
        with span_or_null(tr, "bank.plan", cat="plan"):
            plan = plan_queue(queue, self.style)
        self.stats.bbops += len(queue)
        if self.fuse and self.engine == "interp":
            self._dispatch_fused(queue, plan, results, cancel=cancel)
        else:
            self._dispatch_grouped(queue, plan, results, cancel=cancel)
        self.stats.wall_s += time.perf_counter() - t0
        if root is not None:
            tr.end(root)
        return results

    def _empty_result(self, ins: BbopInstr):
        spec, _, _ = cached_table(ins.op, ins.n_bits, self.style)
        outs = [
            VerticalOperand(np.zeros((w, 0), np.uint32), 0, str(self.device))
            if ins.keep_vertical else np.zeros(0, np.int64)
            for w in spec.out_bits
        ]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _skip_zero_lane(self, queue, i, needed, planes_cache, results):
        """Zero-lane instructions produce empty results without a replay
        slot (and publish empty planes if a consumer references them)."""
        results[i] = self._empty_result(queue[i])
        spec, _, _ = cached_table(queue[i].op, queue[i].n_bits, self.style)
        for o, w in enumerate(spec.out_bits):
            if (i, o) in needed:
                planes_cache[(i, o)] = np.zeros((w, 0), np.uint32)

    # -- fused dataflow dispatcher -----------------------------------------
    def _dispatch_fused(self, queue, plan, results, cancel=None):
        lanes, stage, needed = plan
        planes_cache: Dict[Tuple[int, int], np.ndarray] = {}
        active = []
        for i in range(len(queue)):
            if lanes[i] == 0:
                self._skip_zero_lane(queue, i, needed, planes_cache, results)
            else:
                active.append(i)

        waves = self._build_waves(queue, active, stage, lanes)
        run = hetero_batched_interpreter(self.device)
        tr = active_tracer()
        pending: Optional[Tuple[List[_Slot], torch.Tensor,
                                Optional[torch.cuda.Event]]] = None
        for wave in waves:
            check_cancel(cancel, "bank wave boundary")
            if pending is not None:
                # stage barrier: if this wave forwards planes from the
                # still-in-flight wave, drain it before packing
                in_flight = {s.qi for s in pending[0]}
                if any(isinstance(o, Ref) and o.producer in in_flight
                       for i in wave for o in queue[i].operands):
                    self._harvest_wave(queue, pending, planes_cache,
                                       needed, results)
                    pending = None
            t_pack = time.perf_counter()
            sp_pack = (tr.begin("bank.pack_wave", cat="pack")
                       if tr is not None else None)
            states, tables, entries = self._pack_wave(
                queue, wave, lanes, planes_cache)
            if sp_pack is not None:
                tr.end(sp_pack, slots=len(entries))
            self.stats.pack_wall_s += time.perf_counter() - t_pack
            sp_replay = (tr.begin("bank.replay", cat="replay")
                         if tr is not None else None)
            fut, done = self._submit_wave(run, states, tables, entries)
            c = self._account_wave(
                [(e.uprog, e.lanes, e.sid) for e in entries],
                fused=len({(queue[i].op, queue[i].n_bits,
                            queue[i].signed_out) for i in wave}) > 1)
            if sp_replay is not None:
                tr.charge("bank.replay", c.latency_s, span=sp_replay)
                tr.end(sp_replay, slots=len(entries))
            if pending is not None:
                # double buffering: wave k is harvested only after wave
                # k+1 was packed and submitted, so host pack overlapped
                # device replay
                self._harvest_wave(queue, pending, planes_cache, needed,
                                   results)
            pending = (entries, fut, done)
        if pending is not None:
            with span_or_null(tr, "bank.drain", cat="drain"):
                wait_stacked(pending[-1])      # drain the pipeline
            self._harvest_wave(queue, pending, planes_cache, needed, results)

    def _submit_wave(self, run, states, tables, entries):
        """Submit one packed wave for replay; returns ``(states, event)``.
        Fault-free: asynchronous on the card, with the copy back to pinned
        memory right behind the replay (so the host can read wave k while
        wave k+1 replays) and an event that marks its end.  Fault-injected:
        the synchronous detect/retry/heal loop
        (:func:`~repro_torch.core.fault.faulty_execute`) over the K6
        replay; its healed host states need no event."""
        if self._fault_rt is None:
            return submit_stacked(run, states, tables)
        healed = faulty_execute(
            self.fault, faulty_batched_interpreter(self.device), states,
            tables, [((), entries, self._fault_rt)], self.stats.faults,
            self.cfg)
        return torch.from_numpy(healed.view(np.int32)), None

    def _blacklist_units(self, units) -> int:
        """Retire persistently-failing subarrays (``units`` are
        ``(sid,)`` tuples); returns how many are newly blacklisted."""
        new = {int(u[-1]) for u in units} - self._blacklist
        self._blacklist |= new
        return len(new)

    def _build_waves(self, queue, active, stage,
                     lanes: Optional[Sequence[int]] = None) -> List[List[int]]:
        """Chunk instructions into fused waves.

        Args:
            queue: the full dispatch queue (indexed by ``active``).
            active: queue indices this bank executes, in queue order;
                zero-lane instructions are excluded by the caller.
            stage: per-instruction dependency depth from
                :func:`plan_queue`.
            lanes: per-instruction lane counts from :func:`plan_queue`;
                required for ``packing="reorder"``.

        Returns:
            A list of waves, each a list of queue indices (≤
            ``n_subarrays`` long) that replay in ONE fused launch.  Every
            instruction in ``active`` appears in exactly one wave, and no
            wave contains an instruction whose ``Ref`` producer sits in
            the same or a later wave.  The schedule never affects
            results; it only affects modeled latency and replay count.

        ``packing="reorder"`` is cross-stage list scheduling by
        critical-path cost; because list scheduling alone carries no
        never-worse guarantee, both schedules are priced with the wave
        cost model and the cheaper kept (reorder ≤ ffd by construction).
        ``packing="ffd"``: stages execute in order; within a stage,
        instructions sort by descending program size and first-fit into
        open waves.  ``packing="greedy"``: one open wave, closed as soon
        as an instruction doesn't fit.
        """

        def buckets(i):
            # fusion-compatibility spans, NOT table shapes: the command
            # span keeps a floor of 64 because a wave's replay length is
            # its longest constituent — padding a tiny program into a
            # ≥64-command wave costs nothing extra
            _, uprog, table = cached_table(
                queue[i].op, queue[i].n_bits, self.style)
            return (max(table.shape[0], 64),
                    _round_up(uprog.n_rows_total, ROW_BUCKET))

        if self.packing == "reorder" and lanes is None:
            raise ValueError(
                "packing='reorder' schedules by critical-path cost and "
                "needs the per-instruction lane counts from plan_queue")
        waves: List[List[int]] = []
        for s in sorted({stage[i] for i in active}):
            idxs = sorted((i for i in active if stage[i] == s),
                          key=lambda i: (-buckets(i)[0], -buckets(i)[1], i))
            if self.packing == "greedy":
                waves.extend(self._greedy_waves(idxs, buckets))
            else:
                waves.extend(self._ffd_waves(idxs, buckets))
        if self.packing == "reorder":
            reordered = self._reorder_waves(queue, active, lanes, buckets)
            # never-worse guard: keep the cross-stage schedule only when
            # the cost model prices it at or below the FFD baseline
            if (self._waves_latency_s(queue, reordered, lanes)
                    <= self._waves_latency_s(queue, waves, lanes)):
                return reordered
        return waves

    def _waves_latency_s(self, queue, waves, lanes) -> float:
        """Modeled drain time of a wave schedule: each wave costs its
        longest constituent (serialized invocations included)."""
        return sum(
            max(instr_cost_s(queue[i].op, queue[i].n_bits, lanes[i],
                             self.cfg, self.style) for i in wave)
            for wave in waves if wave
        )

    def _reorder_waves(self, queue, active, lanes, buckets) -> List[List[int]]:
        act = set(active)
        deps = {
            i: {o.producer for o in queue[i].operands
                if isinstance(o, Ref) and o.producer in act}
            for i in active
        }
        consumers: Dict[int, List[int]] = {i: [] for i in active}
        for i in active:
            for p in deps[i]:
                consumers[p].append(i)
        pos = {qi: k for k, qi in enumerate(active)}
        prio = critical_path_s(
            [(queue[i].op, queue[i].n_bits, lanes[i]) for i in active],
            [[pos[c] for c in consumers[i]] for i in active],
            self.cfg, self.style)
        prio_of = dict(zip(active, prio))

        done: set = set()
        remaining = list(active)
        waves: List[List[int]] = []
        while remaining:
            ready = sorted(
                (i for i in remaining if deps[i] <= done),
                key=lambda i: (-prio_of[i], -buckets(i)[0], -buckets(i)[1], i))
            wave: List[int] = []
            span = [0, 0, 0, 0]        # [c_min, c_max, r_min, r_max]
            for i in ready:
                c, r = buckets(i)
                if not wave:
                    wave, span = [i], [c, c, r, r]
                elif (len(wave) < self._wave_capacity
                        and max(span[1], c) <= min(span[0], c)
                        * self.fuse_ratio
                        and max(span[3], r) <= min(span[2], r)
                        * self.fuse_ratio):
                    wave.append(i)
                    span[0], span[1] = min(span[0], c), max(span[1], c)
                    span[2], span[3] = min(span[2], r), max(span[3], r)
            waves.append(wave)
            done.update(wave)
            in_wave = set(wave)
            remaining = [i for i in remaining if i not in in_wave]
        return waves

    def _ffd_waves(self, idxs, buckets) -> List[List[int]]:
        open_: List[List[int]] = []
        spans: List[List[int]] = []    # [c_min, c_max, r_min, r_max]
        for i in idxs:
            c, r = buckets(i)
            for wave, sp in zip(open_, spans):
                if (len(wave) < self._wave_capacity
                        and max(sp[1], c) <= min(sp[0], c) * self.fuse_ratio
                        and max(sp[3], r) <= min(sp[2], r) * self.fuse_ratio):
                    wave.append(i)
                    sp[0], sp[1] = min(sp[0], c), max(sp[1], c)
                    sp[2], sp[3] = min(sp[2], r), max(sp[3], r)
                    break
            else:
                open_.append([i])
                spans.append([c, c, r, r])
        return open_

    def _greedy_waves(self, idxs, buckets) -> List[List[int]]:
        waves: List[List[int]] = []
        wave: List[int] = []
        c_max = r_min = r_max = 0
        for i in idxs:
            c, r = buckets(i)
            if wave:
                # sorted by cmds desc, so c_max is the wave head's; the
                # row span needs running min/max (rows do not follow the
                # command-count order)
                if (len(wave) >= self._wave_capacity
                        or c_max > c * self.fuse_ratio
                        or max(r_max, r) > min(r_min, r)
                        * self.fuse_ratio):
                    waves.append(wave)
                    wave = []
            if not wave:
                c_max, r_min, r_max = c, r, r
            else:
                r_min, r_max = min(r_min, r), max(r_max, r)
            wave.append(i)
        if wave:
            waves.append(wave)
        return waves

    def _wave_dims(self, queue, wave, lanes) -> Tuple[int, int, int]:
        """(n_rows, n_cmds, cols) one fused wave needs.  Rows and columns
        are harmonized to power-of-two buckets (padding is inert: NOP rows
        / zero planes), which keeps the set of distinct replay shapes
        O(log) in the largest wave."""
        metas = [cached_table(queue[i].op, queue[i].n_bits, self.style)
                 for i in wave]
        return (shape_bucket(max(m[1].n_rows_total for m in metas),
                             ROW_BUCKET),
                max(m[2].shape[0] for m in metas),
                shape_bucket(max(lanes[i] for i in wave), 32))

    def _pack_wave(self, queue, wave, lanes, planes_cache,
                   n_rows: Optional[int] = None, n_cmds: Optional[int] = None,
                   cols: Optional[int] = None, with_tables: bool = True):
        """Build the stacked host states and the cached device tables for
        one wave.

        Idle subarrays keep all-zero tables (pure NOPs) and zero states;
        shorter constituent tables are NOP-padded to the wave's shared
        command bucket, shallower state slabs zero-padded to its row
        bucket.  Vertical operands (``Ref`` forwards and user-supplied
        ``VerticalOperand``) write their planes straight into the state —
        the skipped h2v conversions are credited to the stats at the
        :func:`~repro_torch.core.costmodel.forwarding_saving_s` price,
        while horizontal operands charge the same price as paid
        transposition time (``transpose_s``).

        ``n_rows``/``n_cmds``/``cols`` override the wave's own dims with
        larger ones (NOP rows / zero planes are inert) — the chip
        dispatcher passes the max over all banks in a round.

        Slots are assigned least-loaded-first: members sorted by
        descending lane demand take the subarrays with the lightest
        cumulative lane load (results never depend on slot choice).

        Returns ``(states, tables, entries)``; ``tables`` is the
        :class:`~repro_torch.core.control_unit.CommandTables` (device
        tables and their schedule) from
        :data:`~repro_torch.core.control_unit.TABLE_CACHE`.  With
        ``with_tables=False`` (the chip dispatcher, which stacks its
        own round tables) ``tables`` is the wave's composition key and
        no table is resolved.
        """
        metas = [cached_table(queue[i].op, queue[i].n_bits, self.style)
                 for i in wave]
        own_rows, own_cmds, own_cols = self._wave_dims(queue, wave, lanes)
        n_rows = max(n_rows or 0, own_rows)
        n_cmds = max(n_cmds or 0, own_cmds)
        cols = max(cols or 0, own_cols)
        words = cols // 32
        states = np.zeros((self.n_subarrays, n_rows, words), np.uint32)
        entries: List[_Slot] = []
        order = sorted(range(len(wave)), key=lambda j: -lanes[wave[j]])
        free = [int(s) for s in np.argsort(self._lane_load, kind="stable")
                if int(s) not in self._blacklist]
        sids = [0] * len(wave)
        for j in order:
            sids[j] = free.pop(0)
        slot_ops: List = [None] * self.n_subarrays
        for j, (i, (spec, uprog, table)) in enumerate(zip(wave, metas)):
            sid = sids[j]
            self._lane_load[sid] += lanes[i]
            slot_ops[sid] = (queue[i].op, queue[i].n_bits)
            ins = queue[i]
            horiz: List[Optional[np.ndarray]] = []
            vert: Dict[int, np.ndarray] = {}
            for k, o in enumerate(ins.operands):
                if isinstance(o, Ref):
                    vert[k] = _adapt_planes(
                        planes_cache[(o.producer, o.out)],
                        len(uprog.in_rows[k]), words,
                        sign_extend=queue[o.producer].signed_out)
                    horiz.append(None)
                    self._save_transpose(forwarding_saving_s(
                        lanes[i], spec.operand_bits[k], self.cfg))
                elif isinstance(o, VerticalOperand):
                    vert[k] = _adapt_planes(
                        o.planes, len(uprog.in_rows[k]), words,
                        sign_extend=False)
                    horiz.append(None)
                    self._save_transpose(forwarding_saving_s(
                        o.lanes, spec.operand_bits[k], self.cfg))
                else:
                    horiz.append(np.asarray(o))
                    self._pay_transpose(forwarding_saving_s(
                        lanes[i], spec.operand_bits[k], self.cfg))
            st = load_state(uprog, horiz, cols, n_rows=n_rows,
                            out=states[sid])
            for k, planes in vert.items():
                st[list(uprog.in_rows[k])] = planes
            entries.append(_Slot(i, sid, spec, uprog, lanes[i]))
        wave_key = (self.style, n_cmds, tuple(slot_ops))
        if not with_tables:
            return states, wave_key, entries
        return states, self._cached_wave_tables(wave_key), entries

    def _cached_wave_tables(self, wave_key) -> CommandTables:
        """Device-resident (n_subarrays, n_cmds, 13) stacked tables and
        their schedule for one wave composition, built once per distinct
        key."""
        return TABLE_CACHE.get(
            ("bank", self.n_subarrays, str(self.device)) + wave_key,
            lambda: _build_stacked_tables(wave_key, self.n_subarrays),
            self.device)

    def _harvest_wave(self, queue, pending, planes_cache, needed, results):
        """Materialize one completed wave (waiting for its states to
        arrive on the host): publish forwarded planes for downstream
        consumers, and produce user-facing results — vertical
        (``keep_vertical``, v2h skipped) or horizontal via
        :func:`read_outputs`."""
        entries, states, done = pending
        with span_or_null(active_tracer(), "bank.unpack", cat="unpack",
                          slots=len(entries)):
            self._harvest_out(queue, entries, drain_stacked(states, done),
                              planes_cache, needed, results)

    def _harvest_out(self, queue, entries, out, planes_cache, needed,
                     results):
        """Harvest from an executed (n_subarrays, n_rows, n_words) host
        uint32 array — split from :meth:`_harvest_wave` so the chip
        dispatcher can harvest each bank's slab of a stacked round."""
        for e in entries:
            ins = queue[e.qi]
            sub = out[e.sid]
            per_out_rows = output_plane_rows(e.spec.out_bits, e.uprog)
            for o, rows in enumerate(per_out_rows):
                if (e.qi, o) in needed:
                    planes_cache[(e.qi, o)] = sub[rows].copy()
            if ins.keep_vertical:
                words = -(-e.lanes // 32)
                outs = [VerticalOperand(sub[rows][:, :words].copy(), e.lanes,
                                        str(self.device))
                        for rows in per_out_rows]
                self._save_transpose(
                    sum(forwarding_saving_s(e.lanes, w, self.cfg)
                        for w in e.spec.out_bits),
                    skipped=len(outs))
                results[e.qi] = outs[0] if len(outs) == 1 else tuple(outs)
            else:
                outs = read_outputs(
                    e.spec.out_bits, e.uprog, sub, e.lanes, ins.signed_out)
                self._pay_transpose(sum(
                    forwarding_saving_s(e.lanes, w, self.cfg)
                    for w in e.spec.out_bits))
                results[e.qi] = outs[0] if len(outs) == 1 else tuple(outs)

    # -- grouped baseline dispatcher ---------------------------------------
    def _dispatch_grouped(self, queue, plan, results, cancel=None):
        """Per-(op, width, signedness) grouped replay (the pre-fusion
        path, kept as the bit-exactness baseline and for the bitplane /
        cuda engines).  Ref and VerticalOperand operands are materialized
        horizontally — every producer→consumer hop pays the v2h→h2v round
        trip the fused path skips."""
        lanes, stage, needed = plan
        planes_cache: Dict[Tuple[int, int], np.ndarray] = {}
        for s in sorted(set(stage)):
            check_cancel(cancel, "bank stage boundary")
            groups: Dict[Tuple[str, int, bool], List[int]] = {}
            for i in (i for i in range(len(queue)) if stage[i] == s):
                if lanes[i] == 0:
                    self._skip_zero_lane(
                        queue, i, needed, planes_cache, results)
                    continue
                ins = queue[i]
                groups.setdefault(
                    (ins.op, ins.n_bits, ins.signed_out), []).append(i)
            for (op, n_bits, signed_out), idxs in groups.items():
                for c in range(0, len(idxs), self.n_subarrays):
                    chunk = idxs[c: c + self.n_subarrays]
                    sids = [(self._rr_next + j) % self.n_subarrays
                            for j in range(len(chunk))]
                    self._rr_next = (
                        self._rr_next + len(chunk)) % self.n_subarrays
                    sets = [self._materialize_operands(queue, queue[i],
                                                       results)
                            for i in chunk]
                    outs = self.execute_batch(
                        op, n_bits, sets, signed_out, subarray_ids=sids)
                    for i, o in zip(chunk, outs):
                        if queue[i].keep_vertical:
                            o = self._pack_result(queue[i], o)
                        results[i] = o

    def _materialize_operands(self, queue, ins, results) -> List[np.ndarray]:
        ops: List[np.ndarray] = []
        for o in ins.operands:
            if isinstance(o, Ref):
                prod = queue[o.producer]
                r = results[o.producer]
                vals = r[o.out] if isinstance(r, tuple) else r
                if isinstance(vals, VerticalOperand):
                    # NOT charged: the grouped engine computed this value
                    # horizontally one step earlier (the wrapper only
                    # exists because the producer was keep_vertical), so
                    # unwrapping is bookkeeping, not a modeled conversion
                    vals = vals.to_values(signed=prod.signed_out)
                ops.append(np.asarray(vals))
            elif isinstance(o, VerticalOperand):
                self._pay_transpose(forwarding_saving_s(
                    o.lanes, int(o.planes.shape[0]), self.cfg))
                ops.append(o.to_values())
            else:
                ops.append(np.asarray(o))
        return ops

    def _pack_result(self, ins: BbopInstr, result):
        spec, _, _ = cached_table(ins.op, ins.n_bits, self.style)
        outs = result if isinstance(result, tuple) else (result,)
        vos = [VerticalOperand.from_values(np.asarray(v), w,
                                           device=self.device)
               for v, w in zip(outs, spec.out_bits)]
        self._pay_transpose(sum(
            forwarding_saving_s(vo.lanes, w, self.cfg)
            for vo, w in zip(vos, spec.out_bits)))
        return vos[0] if len(vos) == 1 else tuple(vos)

    def reset_stats(self):
        """Zero the stats AND both allocation cursors (fused lane loads,
        grouped round-robin) so re-runs allocate deterministically.  The
        fault blacklist survives — retired subarrays are physical state,
        not statistics."""
        self.stats = BankStats(self.n_subarrays)
        self._lane_load = np.zeros(self.n_subarrays, np.int64)
        self._rr_next = 0


def submit_stacked(run, states: np.ndarray, tables):
    """Enqueue one stacked replay (a bank's wave, or a chip, channel or
    rank round) and return ``(states, event)``: on the card, the copy of
    the executed states back to pinned host memory right behind the
    launch, and an event that marks its end (the host reads the replay
    after the next one was submitted); on the CPU, the executed states
    and no event.  A round split across a device mesh
    (:class:`~repro_torch.core.control_unit.SlabRound`) copies each slab
    back on its own stream, with one event a slab."""
    fut = run(states, tables)
    if isinstance(fut, SlabRound):
        return fut.to_host()
    if not fut.is_cuda:
        return fut, None
    fut = fut.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return fut, done


def wait_stacked(done) -> None:
    """Wait for the copy back of a replay :func:`submit_stacked`
    enqueued, every slab's of a split round (nothing to wait for on the
    CPU or a healed fault-injected replay)."""
    for event in done if isinstance(done, list) else (done,):
        if event is not None:
            event.synchronize()


def drain_stacked(fut, done) -> np.ndarray:
    """The executed host states of a replay :func:`submit_stacked`
    enqueued (waiting for its copy; a split round's slabs put together in
    the unit order), or of a healed fault-injected one (already a host
    array), as uint32.  With a tracer, the device times of the launches
    that have completed by now go to their ``*.replay`` spans."""
    wait_stacked(done)
    tr = active_tracer()
    if tr is not None:
        tr.resolve_device()
    if isinstance(fut, SlabRound):
        fut = fut.assemble()
    if isinstance(fut, torch.Tensor):
        return fut.numpy().view(np.uint32)
    return fut


def _build_stacked_tables(wave_key, n_subarrays: int) -> np.ndarray:
    """Materialize one wave composition's stacked (n_subarrays, n_cmds,
    13) command tables — the TABLE_CACHE build function (runs once per
    distinct key; idle slots stay all-NOP)."""
    style, n_cmds, slot_ops = wave_key
    out = np.zeros((n_subarrays, n_cmds, CMD_WIDTH), np.int32)
    for sid, slot in enumerate(slot_ops):
        if slot is None:
            continue
        op, n_bits = slot
        _, _, table = cached_table(op, n_bits, style)
        out[sid, : table.shape[0]] = table
    return out


def _adapt_planes(planes: np.ndarray, n_rows: int, n_words: int,
                  sign_extend: bool) -> np.ndarray:
    """Width-adapt forwarded (w, W) bit-planes to a consumer expecting
    ``n_rows`` planes of ``n_words`` words: high planes truncate (packing
    a horizontal value keeps only the low bits), missing planes extend
    with the producer's sign plane (a signed producer's horizontal value
    is two's-complement, so its high bits replicate the sign bit) or
    zeros (unsigned)."""
    out = np.zeros((n_rows, n_words), np.uint32)
    w = min(planes.shape[0], n_rows)
    cw = min(planes.shape[1], n_words)
    out[:w, :cw] = planes[:w, :cw]
    if sign_extend and 0 < planes.shape[0] < n_rows:
        out[planes.shape[0]:, :cw] = planes[planes.shape[0] - 1, :cw]
    return out
