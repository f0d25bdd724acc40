"""SIMDRAM ISA surface (``bbop_*``) + backend dispatch.

Counterpart of :mod:`repro.core.isa`.  The paper extends the host ISA
with instructions that set up / convert data layout and trigger in-DRAM
execution of a named operation.  This module is the programmer-facing
equivalent: a per-(op, width) compilation cache ("μProgram memory") and
a backend switch:

  backend="subarray"   faithful row-granular DRAM simulation (numpy oracle)
  backend="interp"     the control unit: one command-table replay (K5)
  backend="bitplane"   fused bit-plane circuits (pack → K3 → unpack)
  backend="cuda"       the hand-kernel fast path: h2v (K1) → K3 → v2h (K2);
                       the counterpart of the reference's "pallas"
  backend="bank"       bank-level engine: lanes split across all compute
                       subarrays, fused waves on K5 (see
                       :mod:`repro_torch.core.bank`)
  backend="chip"       ``cfg.n_banks`` banks, one K5 launch per stacked
                       round (:mod:`repro_torch.core.chip`)
  backend="channel"    ``cfg.n_chips`` chips sharing one host link, one
                       K5 launch per super-round
                       (:mod:`repro_torch.core.channel`)
  backend="rank"       ``cfg.n_channels`` channels, one K5 launch per rank
                       round (:mod:`repro_torch.core.rank`)

``fault`` (a :class:`~repro_torch.core.fault.FaultModel`) goes to the
bank, chip and channel engines, which inject faults on the K6 replay;
the rank engine rejects an enabled model and the single-unit backends
ignore it, as in the reference.  ``device`` (default
``"cuda"``) selects where tensors live: the kernels run on the card;
``device="cpu"`` runs their plain versions.  Results come back as host
numpy arrays.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels import ops as kops
from ..kernels.build import resolve_device
from . import bitplane
from .allocation import compile_circuit
from .control_unit import (encode_uprogram, load_state, read_outputs,
                           run_command_table)
from .energy import uprogram_energy_nj
from .ops_library import OpSpec, get_op
from .subarray import run_op
from .synthesis import compact as compact_uprogram
from .synthesis import synthesize, to_mig
from .timing import DDR4, DramConfig, uprogram_latency_s
from .uprogram import UProgram

BACKENDS = ("subarray", "interp", "bitplane", "cuda", "bank", "chip",
            "channel", "rank")


def compile_op(name: str, n_bits: int, style: str = "mig",
               compact: bool = True) -> Tuple[OpSpec, UProgram]:
    """Steps 1+2 for one op: circuit -> optimized MIG -> μProgram.

    Args:
        name: operation name from :mod:`repro_torch.core.ops_library`
            (``get_op`` raises on unknown names).
        n_bits: element width the μProgram computes over.
        style: ``"mig"`` is the SIMDRAM pipeline (MAJ/NOT synthesis);
            ``"aig"`` compiles the AND/OR/NOT description (the Ambit
            baseline executes this program).
        compact: ``True`` (default) runs the Step-2.5 peephole over the
            allocated command stream; ``False`` keeps the raw allocator
            output.

    Returns:
        ``(spec, uprog)`` — the op's :class:`OpSpec` and the allocated
        :class:`UProgram` ready for :func:`encode_uprogram`.

    Defaults are resolved here so that ``compile_op(op, 8)`` and
    ``compile_op(op, 8, compact=True)`` share one cache entry.
    """
    return _compile_op(name, n_bits, style, bool(compact))


@functools.lru_cache(maxsize=512)
def _compile_op(name: str, n_bits: int, style: str,
                compact: bool) -> Tuple[OpSpec, UProgram]:
    spec = get_op(name, n_bits)
    circ, ids = spec.build(style)
    if style == "mig":
        opt, _ = synthesize(circ)
    else:
        opt = to_mig(circ)   # naive translation: AND/OR cost 1 TRA each, XOR expands
    name2id = {opt.names[i]: i for i in range(len(opt.ops)) if opt.ops[i] == "in"}
    ids_m = [[name2id[circ.names[nid]] for nid in op] for op in ids]
    uprog = compile_circuit(opt, ids_m, op_name=name, n_bits=n_bits)
    if compact:
        uprog, _ = compact_uprogram(uprog)
    return spec, uprog


def compile_shift(n_bits: int, k: int) -> Tuple[None, UProgram]:
    """Bit-shift as pure row re-indexing — ZERO DRAM commands (paper §2:
    "by simply changing the row indices of the SIMDRAM commands that read
    the shifted data").  Vacated bit positions read the constant C0 row."""
    from .uprogram import C0, N_SPECIAL
    in_rows = [[N_SPECIAL + j for j in range(n_bits)]]
    out_rows = []
    for j in range(n_bits):
        src = j - k                      # left shift by k: out[j] = in[j-k]
        out_rows.append([in_rows[0][src] if 0 <= src < n_bits else C0])
    return None, UProgram(
        op_name=f"shift_{k}", n_bits=n_bits, commands=[],
        in_rows=in_rows, out_rows=out_rows,
        n_rows_total=N_SPECIAL + n_bits, n_scratch=0,
    )


class DispatchCancelled(RuntimeError):
    """A dispatch was abandoned at a wave boundary because the caller's
    ``cancel`` callback reported the work is no longer wanted.  No
    results are produced; modeled costs already charged for completed
    waves stay charged."""


class DispatchGuard:
    """Non-blocking re-entrancy guard for the dispatch entry points.

    The fused dispatcher keeps double-buffered pack state on the engine
    object while a queue drains, so a second concurrent ``dispatch`` on
    the same engine would interleave with — and corrupt — the first.  The
    guard turns that into an immediate ``RuntimeError``.
    """

    __slots__ = ("_name", "_lock", "_owner")

    def __init__(self, name: str):
        self._name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def __enter__(self) -> "DispatchGuard":
        if not self._lock.acquire(blocking=False):
            raise RuntimeError(
                f"{self._name}.dispatch re-entered while another dispatch "
                f"is in flight on this engine (owner thread "
                f"{self._owner}); engines keep double-buffered pack state "
                f"and are not re-entrant — serialize callers or use one "
                f"engine per thread")
        self._owner = threading.get_ident()
        return self

    def __exit__(self, *exc) -> bool:
        self._owner = None
        self._lock.release()
        return False


def check_cancel(cancel: Optional[object], where: str) -> None:
    """Raise :class:`DispatchCancelled` if ``cancel`` (a zero-arg
    callable, or None) reports the in-flight dispatch should stop."""
    if cancel is not None and cancel():
        raise DispatchCancelled(f"dispatch cancelled at {where}")


@dataclass
class CallStats:
    op: str
    n_bits: int
    elements: int
    aap: int
    ap: int
    latency_s: float
    energy_nj: float


@dataclass
class SimdramDevice:
    """A SIMDRAM-enabled memory device: executes bbops, tracks costs."""

    cfg: DramConfig = field(default_factory=lambda: DDR4)
    backend: str = "bitplane"
    style: str = "mig"
    fault: Optional[object] = None        # FaultModel, or None = perfect DRAM
    device: str = "cuda"
    calls: List[CallStats] = field(default_factory=list)
    _bank: Optional[object] = field(default=None, repr=False)
    _chip: Optional[object] = field(default=None, repr=False)
    _channel: Optional[object] = field(default=None, repr=False)
    _rank: Optional[object] = field(default=None, repr=False)
    _guard: DispatchGuard = field(
        default_factory=lambda: DispatchGuard("SimdramDevice"), repr=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of "
                             f"{BACKENDS}")
        self._device = resolve_device(self.device)

    def bank(self):
        """The device's bank-level engine (one compute subarray per bank,
        per the paper's evaluation setup); created lazily."""
        if self._bank is None:
            from .bank import Bank
            self._bank = Bank(
                n_subarrays=self.cfg.n_banks * self.cfg.subarrays_per_bank,
                cfg=self.cfg, style=self.style, fault=self.fault,
                device=self._device)
        return self._bank

    def chip(self):
        """The device's chip-level engine: ``cfg.n_banks`` banks of
        ``cfg.subarrays_per_bank`` subarrays; created lazily."""
        if self._chip is None:
            from .chip import SimdramChip
            self._chip = SimdramChip(
                n_banks=self.cfg.n_banks,
                n_subarrays=self.cfg.subarrays_per_bank,
                cfg=self.cfg, style=self.style, fault=self.fault,
                device=self._device)
        return self._chip

    def channel(self):
        """The device's channel-level engine: ``cfg.n_chips`` chips of
        ``cfg.n_banks`` banks sharing one host↔DRAM link; created
        lazily."""
        if self._channel is None:
            from .channel import SimdramChannel
            self._channel = SimdramChannel(
                n_chips=self.cfg.n_chips, n_banks=self.cfg.n_banks,
                n_subarrays=self.cfg.subarrays_per_bank,
                cfg=self.cfg, style=self.style, fault=self.fault,
                device=self._device)
        return self._channel

    def rank(self):
        """The device's rank-level engine: ``cfg.n_channels`` channels of
        ``cfg.n_chips`` chips each; created lazily.  Fault injection is
        not supported at this tier, as in the reference."""
        if self._rank is None:
            if self.fault is not None and self.fault.enabled:
                raise ValueError(
                    "backend='rank' does not support fault injection yet "
                    "— use backend='channel' or a faulty SimdramChannel")
            from .rank import SimdramRank
            self._rank = SimdramRank(
                n_channels=self.cfg.n_channels, n_chips=self.cfg.n_chips,
                n_banks=self.cfg.n_banks,
                n_subarrays=self.cfg.subarrays_per_bank,
                cfg=self.cfg, style=self.style, device=self._device)
        return self._rank

    def _engines(self):
        return {"bank": self.bank, "chip": self.chip,
                "channel": self.channel, "rank": self.rank}

    def _account(self, name: str, n_bits: int, uprog: UProgram, elements: int):
        # a zero-element call executes no replay (the engines skip it),
        # so it must not bill an invocation either
        n_invocations = (int(np.ceil(elements / self.cfg.simd_lanes)) or 1
                         if elements else 0)
        per_sub = self.cfg.n_banks * self.cfg.subarrays_per_bank
        self.calls.append(
            CallStats(
                op=name,
                n_bits=n_bits,
                elements=elements,
                aap=uprog.n_aap * n_invocations,
                ap=uprog.n_ap * n_invocations,
                latency_s=uprogram_latency_s(uprog, self.cfg) * n_invocations,
                energy_nj=uprogram_energy_nj(uprog, self.cfg) * n_invocations * per_sub,
            )
        )

    def bbop_shift(self, x, k: int, n_bits: int):
        """Left-shift by k (k<0 = right): zero commands, zero latency."""
        _, uprog = compile_shift(n_bits, k)
        self._account(uprog.op_name, n_bits, uprog,
                      int(np.asarray(x).shape[-1]))
        outs = run_op(uprog, [n_bits],
                      [np.asarray(x).astype(np.uint64)],
                      n_columns=_round_up(int(np.asarray(x).shape[-1]), 32))
        return outs[0].astype(np.int64)

    # -- the bbop instruction ------------------------------------------------
    def bbop(self, name: str, *operands, n_bits: int, signed_out: bool = False):
        """Execute one SIMDRAM operation over flat integer operands."""
        spec, uprog = compile_op(name, n_bits, self.style)
        elements = int(np.asarray(operands[0]).shape[-1])
        self._account(name, n_bits, uprog, elements)

        if self.backend == "subarray":
            outs = run_op(
                uprog, spec.out_bits,
                [np.asarray(o).astype(np.uint64) for o in operands],
                n_columns=_round_up(elements, 32),
            )
            outs = [o.astype(np.int64) for o in outs]
            if signed_out:
                outs = [_np_signed(o, w) for o, w in zip(outs, spec.out_bits)]
            return outs[0] if len(outs) == 1 else tuple(outs)

        if self.backend == "interp":
            return self._run_interp(spec, uprog, operands, signed_out)

        engines = self._engines()
        if self.backend in engines:
            return engines[self.backend]().bbop(
                name, *operands, n_bits=n_bits, signed_out=signed_out)

        if self.backend == "cuda":
            return kops.to_host(kops.bbop_cuda(
                name, n_bits, *operands, signed_out=signed_out,
                device=self._device))
        return kops.to_host(bitplane.bbop(
            name, n_bits, *operands, signed_out=signed_out,
            device=self._device))

    def _run_interp(self, spec, uprog, operands, signed_out):
        elements = int(np.asarray(operands[0]).shape[-1])
        cols = _round_up(elements, 32)
        state = load_state(uprog, operands, cols)
        table = encode_uprogram(uprog)
        out = run_command_table(state, table, self._device)
        out_state = out.cpu().numpy().view(np.uint32)
        outs = read_outputs(spec.out_bits, uprog, out_state, elements,
                            signed_out)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def dispatch(self, queue, cancel=None) -> List:
        """Drain a queue of bbops through the fused dataflow dispatcher.

        Args:
            queue: iterable of :class:`repro_torch.core.bank.BbopInstr`
                (materialized to a list).  ``Ref`` operands must point at
                earlier entries; heterogeneous ops fuse into one replay
                per wave and ``Ref``/``VerticalOperand`` operands forward
                vertically.
            cancel: optional zero-arg callable polled at wave /
                instruction boundaries; returning True aborts the drain
                with :class:`DispatchCancelled`.

        Returns:
            One result per instruction in queue order — an int64 array
            per output (tuple for multi-output ops), or
            :class:`repro_torch.core.bank.VerticalOperand` for
            ``keep_vertical`` instructions.

        Routing: the rank, channel, chip or fused bank engine for
        ``backend="rank"``/``"channel"``/``"chip"``/``"bank"``, and a
        per-instruction sequential drain for the single-subarray backends
        (``bitplane``/``cuda``/``subarray``/``interp``): each instruction
        executes through :meth:`bbop` in queue order with ``Ref``/vertical
        operands materialized horizontally.  Every path accumulates one
        :class:`CallStats` per instruction in :attr:`calls`."""
        from .bank import validate_queue
        from .telemetry import active_tracer
        with self._guard:
            queue = list(queue)     # tolerate iterator queues
            if not queue:
                raise ValueError(
                    "SimdramDevice.dispatch: empty queue — build at least "
                    "one BbopInstr before dispatching")
            tr = active_tracer()
            if tr is None:
                validate_queue(queue, self.style)
                return self._dispatch_validated(queue, cancel)
            root = tr.begin("device.dispatch", cat="dispatch",
                            backend=self.backend, instrs=len(queue))
            try:
                with tr.span("device.validate", cat="plan"):
                    validate_queue(queue, self.style)
                return self._dispatch_validated(queue, cancel)
            finally:
                # the defensive LIFO pop in end() also closes anything an
                # exception (e.g. FaultExhaustedError) left open beneath
                tr.end(root)

    def _dispatch_validated(self, queue, cancel=None) -> List:
        from .bank import plan_queue
        engines = self._engines()
        if self.backend not in engines:
            return self._dispatch_sequential(queue, cancel)
        results = engines[self.backend]().dispatch(queue, cancel=cancel)
        for ins, n in zip(queue, plan_queue(queue, self.style)[0]):
            _, uprog = compile_op(ins.op, ins.n_bits, self.style)
            self._account(ins.op, ins.n_bits, uprog, n)
        return results

    def _dispatch_sequential(self, queue, cancel=None) -> List:
        """Per-instruction queue drain for the engine-less backends.

        ``Ref`` operands materialize horizontally (the producer's result
        re-enters the next :meth:`bbop` as a flat array), and every
        operand is truncated to its spec width — exactly the low-bits
        packing the vertical-forwarding engine applies.  :meth:`bbop`
        does the per-instruction accounting."""
        from .bank import Ref, VerticalOperand, cached_table
        results: List = [None] * len(queue)
        for i, ins in enumerate(queue):
            check_cancel(cancel, f"instruction {i}")
            spec, _, _ = cached_table(ins.op, ins.n_bits, self.style)
            operands = []
            for o, w in zip(ins.operands, spec.operand_bits):
                if isinstance(o, Ref):
                    prod = queue[o.producer]
                    r = results[o.producer]
                    vals = r[o.out] if isinstance(r, tuple) else r
                    if isinstance(vals, VerticalOperand):
                        vals = vals.to_values(signed=prod.signed_out)
                elif isinstance(o, VerticalOperand):
                    vals = o.to_values()
                else:
                    vals = o
                vals = np.asarray(vals).astype(np.int64)
                if w < 63:
                    vals = vals & ((1 << w) - 1)
                operands.append(vals)
            if int(operands[0].shape[-1]) == 0:
                _, uprog = compile_op(ins.op, ins.n_bits, self.style)
                self._account(ins.op, ins.n_bits, uprog, 0)
                outs = [np.zeros(0, np.int64) for _ in spec.out_bits]
            else:
                r = self.bbop(ins.op, *operands, n_bits=ins.n_bits,
                              signed_out=ins.signed_out)
                outs = list(r) if isinstance(r, tuple) else [r]
            if ins.keep_vertical:
                vos = [VerticalOperand.from_values(np.asarray(v), w,
                                                   device=self._device)
                       for v, w in zip(outs, spec.out_bits)]
                results[i] = vos[0] if len(vos) == 1 else tuple(vos)
            else:
                results[i] = outs[0] if len(outs) == 1 else tuple(outs)
        return results

    # -- reporting -------------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        return {
            "calls": len(self.calls),
            "aap": sum(c.aap for c in self.calls),
            "ap": sum(c.ap for c in self.calls),
            "latency_s": sum(c.latency_s for c in self.calls),
            "energy_mj": sum(c.energy_nj for c in self.calls) * 1e-6,
        }

    def reset(self):
        self.calls.clear()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np_signed(x: np.ndarray, n_bits: int) -> np.ndarray:
    x = x.astype(np.int64) & ((1 << n_bits) - 1)
    return np.where(x >= (1 << (n_bits - 1)), x - (1 << n_bits), x)


# module-level convenience: the 16 ops as bbop_<name> on a default device,
# created on first use (so that importing this module needs no card)
_default_device: Optional[SimdramDevice] = None


def default_device() -> SimdramDevice:
    global _default_device
    if _default_device is None:
        _default_device = SimdramDevice()
    return _default_device


def __getattr__(attr: str):
    if attr.startswith("bbop_"):
        op = attr[len("bbop_"):]
        def call(*operands, n_bits: int, signed_out: bool = False, device=None):
            dev = device or default_device()
            return dev.bbop(op, *operands, n_bits=n_bits, signed_out=signed_out)
        call.__name__ = attr
        return call
    raise AttributeError(attr)
