"""Serving path: prefill and decode steps, a batched request scheduler,
and the PuM hook (counterpart of :mod:`repro.train.serve`).

  - :func:`make_prefill` and :func:`make_serve_step` build the inference
    functions: a full-sequence forward returning last-position logits,
    and one decode step against the caches.  Both run where the params
    are;
  - :class:`Server` is the reference's continuous-batching loop: fixed
    batch slots, per-slot positions, prefill-by-decode, greedy sampling,
    EOS handling, slot reuse;
  - :func:`bbop_host_oracle`, the exact semantics of one ``bbop`` on the
    host — the graceful-degradation path the serving front-end's circuit
    breaker and :class:`PumServeOffload` answer from;
  - :class:`PumStage` and :class:`PumServeOffload`, which route one
    decode step's quantized logits through a
    :class:`~repro_torch.core.chip.SimdramChip` as Ref-linked stage
    chains, one per batch row.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.fault import FaultExhaustedError
from ..core.isa import _np_signed
from ..core.ops_library import get_op
from ..core.telemetry import REGISTRY, active_tracer
from ..kernels.build import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_caches, lm_forward


def _device_of(params) -> torch.device:
    return params["embed"]["emb"].device


def make_prefill(cfg: ModelConfig, remat: str = "dots", unroll: bool = False):
    """Full-sequence forward returning last-position logits (B, V), on the
    params' device."""

    @torch.no_grad()
    def prefill(params, tokens, encoder_feats=None, vision_embeds=None):
        dev = _device_of(params)
        kw = {}
        if cfg.is_encdec:
            kw["encoder_feats"] = torch.as_tensor(encoder_feats, device=dev)
        if cfg.family == "vlm":
            kw["vision_embeds"] = torch.as_tensor(vision_embeds, device=dev)
        logits, _ = lm_forward(params, torch.as_tensor(tokens, device=dev),
                               cfg, remat=remat, unroll=unroll, **kw)
        return logits[:, -1, :]

    return prefill


def make_serve_step(cfg: ModelConfig, unroll: bool = False):
    """One-token decode against a KV/SSM cache (the decode_* cells), on
    the params' device; the caches are written in place and returned."""

    @torch.no_grad()
    def serve_step(params, caches, token, pos, memory=None):
        dev = _device_of(params)
        return decode_step(params, caches, torch.as_tensor(token, device=dev),
                           torch.as_tensor(pos, device=dev), cfg,
                           memory=memory, unroll=unroll)

    return serve_step


def bbop_host_oracle(op: str, n_bits: int, operands,
                     signed_out: bool = False):
    """Host-CPU oracle for ONE bbop — the exact semantics every engine
    tier implements: operands truncate to their spec widths (low-bits
    packing), outputs wrap to their out widths, ``signed_out``
    reinterprets them as two's complement.

    This is the graceful-degradation path: :class:`PumServeOffload` and
    the serving front-end's circuit breaker both answer from it when
    the DRAM ladder exhausts its fault budget.

    Returns an int64 array per output (tuple for multi-output ops) —
    the same result forms as :meth:`repro_torch.core.isa.SimdramDevice
    .bbop`.
    """
    spec = get_op(op, n_bits)
    args = []
    for o, w in zip(operands, spec.operand_bits):
        v = np.asarray(o).astype(np.int64)
        if w < 63:
            v = v & ((1 << w) - 1)
        args.append(v.astype(np.uint64))
    outs = [o.astype(np.int64) for o in spec.oracle(*args)]
    if signed_out:
        outs = [_np_signed(o, w) for o, w in zip(outs, spec.out_bits)]
    return outs[0] if len(outs) == 1 else tuple(outs)


@dataclasses.dataclass(frozen=True)
class PumStage:
    """One quantized elementwise serving stage: a bbop, optionally with a
    broadcast integer constant as the second operand (``const=None`` for
    unary ops like ``relu``)."""

    op: str
    const: Optional[int] = None


class PumServeOffload:
    """Routes quantized elementwise logit stages through a SimdramChip.

    Each call takes one decode step's ``(batch, vocab)`` logits,
    quantizes every row to the unsigned ``n_bits`` grid (per-row affine
    scale), queues one Ref-linked chain of ``stages`` per row, drains
    the whole batch through a single ``chip.dispatch`` (the chip's
    bin-packing scheduler spreads rows across banks; intermediates stay
    vertical within a bank), and dequantizes back.

    Rows whose stage chain turns out to be a no-op on the quantized grid
    pass the ORIGINAL float logits through unchanged (lossless identity
    — quantization resolution must not perturb a pipeline that computed
    nothing).  The default stage pipeline — clamp to the grid via
    ``min``/``max`` with the grid bounds — is such a no-op, so greedy
    decoding is unchanged while the full chip stack runs under real
    batch traffic.  Stages that DO change values (e.g.
    ``PumStage("relu")``) return the dequantized result, which carries
    the n-bit grid's resolution.  ``reference()`` is the numpy oracle of
    the same pipeline, which :meth:`__call__` matches bit-exactly.

    ``chip`` defaults to a 4-bank × 2-subarray
    :class:`~repro_torch.core.chip.SimdramChip` on ``device``.
    """

    def __init__(self, chip=None, stages: Optional[Tuple[PumStage, ...]] = None,
                 n_bits: int = 8, device="cuda"):
        if chip is None:
            from ..core.chip import SimdramChip
            chip = SimdramChip(n_banks=4, n_subarrays=2, device=device)
        self.chip = chip
        self.n_bits = n_bits
        self.host_fallbacks = 0
        hi = (1 << n_bits) - 1
        self.stages = tuple(stages) if stages is not None else (
            PumStage("min", hi), PumStage("max", 0))
        if not self.stages:
            raise ValueError("PumServeOffload needs at least one stage")
        for stage in self.stages:
            spec = get_op(stage.op, n_bits)
            if len(spec.out_bits) != 1:
                raise ValueError(
                    f"stage op {stage.op!r} has {len(spec.out_bits)} "
                    "outputs; logit stages must be single-output")
            want_operands = 1 if stage.const is None else 2
            if spec.n_operands != want_operands:
                raise ValueError(
                    f"stage op {stage.op!r} takes {spec.n_operands} "
                    f"operands but the stage supplies {want_operands} "
                    "(set/unset const)")

    def _quantize(self, x: np.ndarray):
        lo = x.min(axis=-1, keepdims=True)
        scale = (x.max(axis=-1, keepdims=True) - lo) / ((1 << self.n_bits) - 1)
        scale = np.where(scale <= 0, 1.0, scale)
        q = np.rint((x - lo) / scale).astype(np.uint64)
        return q, lo, scale

    def _chain(self, row: np.ndarray, queue: list) -> int:
        """Append one row's stage chain to the queue; return its head."""
        from ..core.bank import BbopInstr, Ref
        prev = None
        for stage in self.stages:
            lead = row if prev is None else Ref(prev)
            operands = (lead,) if stage.const is None else (
                lead, np.full(row.shape[-1], stage.const, np.uint64))
            queue.append(BbopInstr(stage.op, operands, self.n_bits))
            prev = len(queue) - 1
        return prev

    def _dequantize(self, x, q, y, lo, scale) -> np.ndarray:
        """Per row: the original logits if the stages were a grid no-op
        (lossless identity), else the dequantized stage output."""
        noop = (y == q).all(axis=-1, keepdims=True)
        deq = (lo + scale * y.astype(np.float64)).astype(np.float32)
        return np.where(noop, x, deq)

    def __call__(self, logits) -> np.ndarray:
        x = np.asarray(logits, np.float32)
        if x.size == 0:
            return x             # no slots / no vocab: nothing to offload
        q, lo, scale = self._quantize(x)
        queue: list = []
        heads = [self._chain(q[b], queue) for b in range(q.shape[0])]
        tr = active_tracer()
        sp = None
        if tr is not None:
            sp = tr.begin("serve.offload", cat="serve", rows=q.shape[0],
                          instrs=len(queue))
        try:
            out = self.chip.dispatch(queue)
        except FaultExhaustedError as e:
            # the chip ran out of fault-free subarrays mid-serve: fall
            # back to the numpy oracle for this step (same pipeline,
            # same values) and keep serving
            self.host_fallbacks += 1
            REGISTRY.counter("serve.host_fallbacks").inc()
            faults = getattr(self.chip.stats, "faults", None)
            if faults is not None:
                faults.host_fallbacks += 1
            if sp is not None:
                tr.incident("serve_host_fallback", rows=int(q.shape[0]),
                            host_fallbacks=self.host_fallbacks,
                            **e.context())
                with tr.span("serve.host_fallback", cat="serve"):
                    ref = self.reference(logits)
                tr.end(sp, fallback=True)
                return ref
            return self.reference(logits)
        y = np.stack([np.asarray(out[h]).astype(np.uint64)
                      & ((1 << self.n_bits) - 1) for h in heads])
        if sp is not None:
            tr.end(sp)
        return self._dequantize(x, q, y, lo, scale)

    def reference(self, logits) -> np.ndarray:
        """Numpy oracle of the exact same quantize→stages→dequantize
        pipeline (no PuM) — what :meth:`__call__` must match bit-exactly."""
        x = np.asarray(logits, np.float32)
        if x.size == 0:
            return x
        q, lo, scale = self._quantize(x)
        rows = []
        for b in range(q.shape[0]):
            v = q[b].astype(np.uint64)
            for stage in self.stages:
                args = (v,) if stage.const is None else (
                    v, np.full(v.shape[-1], stage.const, np.uint64))
                v = get_op(stage.op, self.n_bits).oracle(*args)[0]
                v = v.astype(np.uint64) & ((1 << self.n_bits) - 1)
            rows.append(v)
        return self._dequantize(x, q, np.stack(rows), lo, scale)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # prompt tokens still to feed (prefill-by-decode)
    _feed: List[int] = dataclasses.field(default_factory=list, init=False,
                                         repr=False, compare=False)


class Server:
    """Greedy continuous-batching server over fixed cache slots on
    ``device``, where the params must be.

    With ``pum_offload``, every step hands the active slots' logits to
    the offload (on the host, as float32) and writes its result back into
    the logits in their own dtype, as the reference writes them into its
    host copy; greedy sampling takes the first maximum, as ``jnp.argmax``
    does.  A step sees the mesh ambient where it runs: under ``with
    mesh:`` a config with ``moe_impl="ep"`` splits its experts over the
    mesh's positions, as the reference's step under ``with mesh:``."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 pum_offload: Optional[PumServeOffload] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        if _device_of(self.params).type != self.device.type:
            raise ValueError(f"the params are on {_device_of(self.params)}, "
                             f"the server on {self.device}")
        self.cfg = cfg
        self.caches = init_caches(cfg, batch_slots, max_len, self.device)
        self.step_fn = make_serve_step(cfg)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.cur = np.zeros(batch_slots, np.int32)
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.pum_offload = pum_offload

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # feed prompt tokens one by one (prefill-by-decode)
                self.pos[i] = 0
                self.cur[i] = req.prompt[0]
                req._feed = list(req.prompt[1:])

    def step(self) -> None:
        self._admit()
        logits, self.caches = self.step_fn(self.params, self.caches,
                                           self.cur, self.pos)
        if self.pum_offload is not None:
            # the active slots' quantized elementwise logit stages drain
            # through one chip dispatch (empty slots hold stale tokens —
            # not real traffic, so not dispatched)
            act = [i for i, s in enumerate(self.slots) if s is not None]
            if act:
                rows = torch.tensor(act, device=logits.device)
                host = logits[rows].to(torch.float32).cpu().numpy()
                logits[rows] = torch.from_numpy(self.pum_offload(host)).to(
                    logits.device, logits.dtype)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if req._feed:
                self.cur[i] = req._feed.pop(0)
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            self.cur[i] = tok
            if tok == self.eos_id or len(req.out) >= req.max_new \
                    or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None

    def run(self, max_steps: int = 512) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
