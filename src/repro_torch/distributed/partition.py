"""Partitioned LM steps over a device mesh: each position computes its
share of the step on its own shards, with explicit collectives.

This module has no file-for-file counterpart in the reference: it is the
port's stand-in for what GSPMD does under ``jax.jit(step,
in_shardings=..., out_shardings=...)`` for the LM's steps.
:func:`partitioned_step` takes a step built by
:func:`~repro_torch.train.serve.make_prefill`,
:func:`~repro_torch.train.serve.make_serve_step` or
:func:`~repro_torch.train.train_loop.make_train_step` (whose program,
backward and optimizer included, is
:mod:`~repro_torch.distributed.partition_train`) and the shardings the
reference passes to ``jax.jit``; the result takes and returns
:class:`~repro_torch.distributed.sharding.Sharded` leaves, as
:func:`~repro_torch.distributed.sharding.sharded_step` does, but never
gathers a whole argument: one program a mesh position in one process,
as :func:`~repro_torch.models.moe.moe_forward_ep` runs it (position
``k`` on ``mesh.device_at(k)`` and, on a card, ``mesh.stream_at(k)``).

The program follows :func:`~repro_torch.distributed.sharding.param_spec`:

- the batch splits over the DATA axes (the tokens' layout for prefill,
  the caches' for decode) and every position holds the whole
  ``d_model`` of its rows;
- column-parallel weights ``(DATA, model)`` are all-gathered over DATA
  (the FSDP gather) and multiply locally, giving ``model``-split
  outputs; row-parallel ones ``(model, DATA)`` likewise, their partial
  outputs all-reduced over ``model``;
- the embedding is vocab-parallel (a masked local lookup, then an
  all-reduce), the readout gives logits laid out by
  :func:`~repro_torch.distributed.sharding.logits_sharding`, norms are
  replicated;
- attention splits query and kv heads over ``model`` where the kv heads
  divide, else ``head_dim`` (the caches' layout from
  :func:`~repro_torch.distributed.sharding.cache_shardings`, which
  decode never reshards): each position's ``q·k`` is then a partial
  score over its ``head_dim`` slice, all-reduced in float32 before the
  softmax, and ``p·v`` gives its slice of every head.  Its slice of
  RoPE needs the rotation's partner dims, which it computes from the
  gathered weights.  Prefill, with no cache to keep, splits the query
  heads instead where they divide (each position projects the kv heads
  its query heads read), since partial scores grow with the square of
  the sequence;
- row-parallel partials are computed and all-reduced in float32 and
  rounded once, as the whole product rounds once;
- any other layout (a shard that does not hold whole heads, a dim that
  ``_fit`` left whole) is all-gathered over its axis before use;
- a MoE block calls :func:`~repro_torch.models.moe.moe_forward_ep` over
  each ``model`` group of positions (with ``moe_impl="ep"`` each data
  shard dispatches alone, as the reference's ``shard_map`` does; else
  the rows are all-gathered first, so that the dispatch is the grouped
  one over the whole batch).  ``moe_impl="dense"`` has no capacity and
  gathers nothing: each ``model`` rank runs its own experts over its
  own rows, weights them by the combine weights of those experts and
  the float32 partials are summed over ``model`` (:meth:`_Program
  .moe_dense`);

Decode returns new caches (the arguments are left as they are, as
``jax.jit`` without donation leaves them), written where the position's
own rows and heads are.  Caches handed in another layout than
``cache_shardings``' (replicated, say, or the batch over ``model``) are
relaid to it on entry (:func:`relayout`, its gathers charged), and the
new caches leave in the caller's ``out_shardings``.

- the PuM MLP (``cfg.pum != "off"`` with a relu) quantizes each
  position's column-parallel ``up`` slice and runs its relu as one
  SIMDRAM bbop on the position's device and stream (K1, K3, K2 on a
  card), then the row-parallel ``down``.
- the SSM mixer (``family="ssm"``, and beside attention in a hybrid
  block, whose two outputs add before the residual) is
  :mod:`~repro_torch.distributed.partition_ssm`: its SSD split by
  heads, else by the head dim, else whole at every ``model`` rank, and
  its conv channels split where they divide, else whole.
- a sliding window masks every attention layout: prefill and train past
  the window take the reference's banded form, and decode writes the
  ring slot ``pos % window`` (:func:`ring_slot`) while RoPE reads the
  true position.
- an encoder-decoder runs its encoder (``frontend_proj`` on
  ``encoder_feats``, the ``enc_blocks`` stack with ``causal=False`` in
  whichever attention layout the step takes, ``enc_ln_f``) on each
  position's rows of the features, split over the DATA axes as the
  tokens are; each decoder block then attends over the memory
  (cross-attention: q from the decoder, k and v from the memory, no
  RoPE, no cache, no mask) by kv heads over ``model`` where they divide,
  else by query heads, else whole (:func:`_cross_mode`), its ``o``
  row-parallel.  Decode takes the memory as an argument and recomputes
  the cross k and v every step, as the reference's ``decode_step`` does.
- int8 weight trees (:func:`~repro_torch.models.quantized.quantize_tree`):
  a ``{"w_q", "scale"}`` weight moves as int8 and float32 pieces (the
  scale laid out by the weight's last dim, the reference's rule) and is
  dequantized at each position as ``layers.dense`` does (:meth:`_Program
  .wfetch`), the MoE's expert stacks too.
- int8 KV caches: ``k_scale``/``v_scale`` follow the kv heads only.  By
  heads each position quantizes its own heads; where ``head_dim`` splits,
  each rank's per-(entry, head) amax over its slice goes through a max
  all-reduce over ``model`` (:func:`all_max`, charged as an all-reduce)
  before any rank rounds, so every rank quantizes with the whole row's
  scale.
- padded kv heads (``kv_head_pad``): decode's cache holds the padded
  heads; by heads each rank projects the kv heads its padded heads
  repeat (:func:`padded_sources`), so query head ``i`` reads padded head
  ``i // (n_heads // kv_head_pad)`` as the reference's GQA does.

The collectives (:func:`all_gather`, :func:`all_reduce`,
:func:`reduce_scatter`, :func:`all_to_all`, :func:`permute`) run over
one or more mesh axes on the positions' devices and streams; sums run
in rank order, in float32, rounded once to the parts' dtype.  Each
charges the :class:`CollectiveLedger` objects active in a ``with``
block, by the reference dry run's ring accounting
(``repro.launch.dryrun.collective_bytes``): an all-gather its output
bytes, an all-reduce twice its input bytes, the others their input
bytes, per position.  :meth:`PartitionedStep.run_position` runs one
position's program alone on ``meta`` (its peers' parts stand in by
shape), which is what the dry run traces.

Under autograd (the train step of
:mod:`~repro_torch.distributed.partition_train`) each collective is a
``torch.autograd.Function`` whose backward is its explicit transpose,
run on the positions' streams, summed in rank order and charged like
any forward collective.  The program follows Megatron's rules over
``model``: a value every ``model`` rank holds whole (the residual
stream) has the whole cotangent at every rank, so the all-reduce of
row-parallel partials (*g*) passes the cotangent through, and such a
value entering computation split over ``model`` goes through
:func:`enter` (*f*: identity forward, all-reduce of the partial
cotangents backward).  An all-gather's backward is a reduce-scatter
where what it gathered feeds split computation (the FSDP gathers of
weights over DATA, whose rows differ), and each position's own part of
its cotangent where the computation after it is duplicated
(``copies``).  Over the DATA axes every position's cotangents are
partials (its rows).  In a no-grad step (serving) nothing of this runs.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import itertools
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import Mesh, mark, on_stream, read_on, wait_for
from ..models import moe
from ..models.attention import (NEG_INF, _scale, attention_heads,
                                band_mask, band_pairs, quantize_kv)
from ..models.layers import (dense, mlp_hidden, pum_relu_hidden, rmsnorm,
                             rope_angles, unembed)
from ..models.params import tree_leaves, tree_map
from ..models.quantized import dequantize_weight, effective_weight
from ..train.serve import make_prefill, make_serve_step
from ..train.train_loop import make_train_step
from . import sharding as shd

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_LEDGERS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collective_ledgers", default=())


class CollectiveLedger:
    """Per-position bytes the collectives moved while this ledger was
    active (``with ledger:``), by kind, in the reference's ring
    accounting; ``calls`` counts the collectives of each kind."""

    def __init__(self):
        self.bytes = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)
        self._tokens: list = []

    def charge(self, kind: str, in_bytes: int, out_bytes: int) -> None:
        self.bytes[kind] += (out_bytes if kind == "all-gather" else
                             2 * in_bytes if kind == "all-reduce" else
                             in_bytes)
        self.calls[kind] += 1

    def totals(self) -> dict:
        """Bytes by kind and their ``total``, as floats (the reference's
        ``collective_bytes`` record)."""
        out = {k: float(v) for k, v in self.bytes.items()}
        out["total"] = float(sum(self.bytes.values()))
        return out

    def __enter__(self) -> "CollectiveLedger":
        self._tokens.append(_LEDGERS.set(_LEDGERS.get() + (self,)))
        return self

    def __exit__(self, *exc) -> None:
        _LEDGERS.reset(self._tokens.pop())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# positions and collectives
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Positions:
    """The positions of ``mesh`` a program runs: every one (a run, each
    on its own device and stream), or the one of ``ks`` on ``meta`` (a
    trace of that position alone)."""

    def __init__(self, mesh: Mesh, ks: Sequence[int], meta: bool = False):
        self.mesh = mesh
        self.ks = tuple(ks)
        self.meta = meta
        if meta:
            self.devs = [torch.device("meta")] * len(self.ks)
            self.streams = [None] * len(self.ks)
        else:
            if mesh.abstract:
                raise ValueError(f"{mesh!r} has no devices to run on")
            self.devs = [mesh.device_at(k, None) for k in self.ks]
            self.streams = [mesh.stream_at(k, d)
                            for k, d in zip(self.ks, self.devs)]
        self._index = {k: i for i, k in enumerate(self.ks)}
        self._coords = {k: self._coords_of(k) for k in self.ks}

    def _coords_of(self, k: int) -> dict:
        out = {}
        for a in reversed(self.mesh.axis_names):
            k, out[a] = divmod(k, self.mesh.shape[a])
        return out

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def part(self, k: int, axes: Sequence[str]) -> int:
        """Which part of a dim split over ``axes`` (the first major)
        position ``k`` holds."""
        part = 0
        for a in axes:
            part = part * self.mesh.shape[a] + self._coords[k][a]
        return part

    def group(self, k: int, axes: Sequence[str]) -> List[int]:
        """The positions that differ from ``k`` only along ``axes``, in
        part order."""
        at = self._coords[k]
        return [self.mesh.position(**{**at, **dict(zip(axes, c))})
                for c in itertools.product(*(range(self.mesh.shape[a])
                                             for a in axes))]

    def map(self, fn: Callable, *args: list) -> list:
        """``fn`` at each position on its device and stream, over the
        positions' entries of ``args`` (lists in ``ks`` order)."""
        out = []
        for i in range(len(self.ks)):
            with on_stream(self.devs[i], self.streams[i]):
                out.append(fn(*(a[i] for a in args)))
        return out

    def same(self, x) -> list:
        return [x] * len(self.ks)

    def join(self, vals: list) -> None:
        """The current stream of each position's device waits for what
        its stream queued, and reads ``vals`` (one tensor a position)
        there."""
        for v, dev, s in zip(vals, self.devs, self.streams):
            if s is not None:
                cur = torch.cuda.current_stream(dev)
                wait_for(cur, mark(s))
                read_on(v, cur)


def _exchange(pos: Positions, vals: list, axes: Sequence[str], kind: str,
              combine: Callable) -> list:
    """Each position's ``combine(parts, i)`` over the parts of its group
    along ``axes`` (``i`` its own place among them), computed on its
    device and stream after the peers' streams reach their parts; a
    trace of one position stands its own part in for its peers'.  A
    group of one moves nothing and is not charged."""
    axes = tuple(axes)
    if pos.size(axes) == 1:
        return list(vals)
    done = [mark(s) for s in pos.streams]
    out = []
    for i, k in enumerate(pos.ks):
        members = pos.group(k, axes)
        with on_stream(pos.devs[i], pos.streams[i]):
            parts = []
            for m in members:
                j = pos._index.get(m)
                if j is None:
                    parts.append(vals[i])
                    continue
                wait_for(pos.streams[i], done[j])
                parts.append(read_on(vals[j], pos.streams[i]).to(
                    pos.devs[i]))
            out.append(combine(parts, members.index(k)))
    for ledger in _LEDGERS.get():
        ledger.charge(kind, _nbytes(vals[0]), _nbytes(out[0]))
    return out


def _sum(parts: list) -> torch.Tensor:
    """The parts added in rank order in float32, rounded once to their
    dtype (exact for the one-hot sums of a masked lookup)."""
    return functools.reduce(torch.add, [p.to(torch.float32) for p in parts]
                            ).to(parts[0].dtype)


class _Transposed(torch.autograd.Function):
    """A collective over the positions (one input and one output a
    position) whose backward is ``bwd``, its transpose, given every
    position's cotangent.  The positions' streams first wait for the
    engine's (which the cotangents are ready on), and the engine's
    stream then waits for theirs."""

    @staticmethod
    def forward(ctx, pos, fwd, bwd, *vals):
        ctx.pos, ctx.bwd = pos, bwd
        return tuple(fwd(list(vals)))

    @staticmethod
    def backward(ctx, *cts):
        pos = ctx.pos
        for dev, s in zip(pos.devs, pos.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
        out = ctx.bwd(list(cts))
        pos.join(out)
        return (None, None, None, *out)


def _collective(pos: Positions, vals: list, axes, fwd: Callable,
                bwd: Callable) -> list:
    """``fwd(vals)``, recorded for autograd with the backward ``bwd``
    where a gradient is being taken through ``vals``; a group of one
    position is the identity both ways."""
    if pos.size(tuple(axes)) == 1:
        return list(vals)
    if not (torch.is_grad_enabled() and any(v.requires_grad for v in vals)):
        return fwd(list(vals))
    return list(_Transposed.apply(pos, fwd, bwd, *vals))


def _part_sizes(pos: Positions, vals: list, axes: Sequence[str],
                dim: int) -> Optional[List[int]]:
    """The sizes along ``dim`` of the parts of a dim split over ``axes``
    (each position's entry of ``vals`` its part), in part order, where
    they differ (uneven microbatch rows); None where they are equal.  A
    trace of one position stands its own size in for its peers'."""
    sizes = [vals[0].shape[dim]] * pos.size(axes)
    for k, v in zip(pos.ks, vals):
        sizes[pos.part(k, axes)] = v.shape[dim]
    return None if len(set(sizes)) == 1 else sizes


def _cut(t: torch.Tensor, dim: int, n: int, i: int,
         sizes: Optional[List[int]] = None) -> torch.Tensor:
    """Part ``i`` of ``t`` cut along ``dim`` into ``n`` equal parts, or
    into parts of ``sizes``."""
    if sizes is None:
        return t.chunk(n, dim)[i]
    return t.narrow(dim, sum(sizes[:i]), sizes[i])


def _own(pos: Positions, vals: list, axes: Sequence[str], dim: int,
         sizes: Optional[List[int]] = None) -> list:
    """Each position's own part, cut along ``dim``, of a whole value."""
    n = pos.size(axes)
    return [_cut(v, dim, n, pos.part(k, axes), sizes)
            for k, v in zip(pos.ks, vals)]


def all_gather(pos: Positions, vals: list, axes: Sequence[str],
               dim: int, copies: bool = False) -> list:
    """Every position gets its group's parts (of equal sizes, or of
    uneven ones) concatenated along ``dim`` in part order.  Backward:
    the cotangents' reduce-scatter into the parts' sizes (each
    position's a partial: the computation after the gather is split
    over ``axes``), or where ``copies`` (that computation is duplicated,
    every position's cotangent the whole one) each position's own part
    of its cotangent, which moves nothing."""
    axes = tuple(axes)
    sizes = _part_sizes(pos, vals, axes, dim)

    def backward(c):
        if copies:
            return _own(pos, c, axes, dim, sizes)
        if sizes is None:
            return reduce_scatter(pos, c, axes, dim)
        return reduce_scatter(pos, c, axes, dim, sizes)

    return _collective(
        pos, vals, axes,
        lambda v: _exchange(pos, v, axes, "all-gather",
                            lambda parts, _: torch.cat(parts, dim)),
        backward)


def all_reduce(pos: Positions, vals: list, axes: Sequence[str]) -> list:
    """Every position gets its group's sum, added in rank order.  The
    sum of partials into a value every position holds whole (Megatron's
    *g*): backward passes each position's cotangent through."""
    axes = tuple(axes)
    return _collective(
        pos, vals, axes,
        lambda v: _exchange(pos, v, axes, "all-reduce",
                            lambda parts, _: _sum(parts)),
        lambda c: c)


def all_max(pos: Positions, vals: list, axes: Sequence[str]) -> list:
    """Every position gets its group's elementwise maximum (exact in
    any order), charged as an all-reduce.  Serving only: no backward."""
    axes = tuple(axes)
    return _exchange(pos, vals, axes, "all-reduce",
                     lambda parts, _: functools.reduce(torch.maximum, parts))


def reduce_scatter(pos: Positions, vals: list, axes: Sequence[str],
                   dim: int, sizes: Optional[List[int]] = None) -> list:
    """The group's rank-order sum, cut along ``dim`` (into equal parts,
    or into parts of ``sizes``): part ``i`` to the group's ``i``-th
    position.  Backward: the cotangents' all-gather."""
    axes = tuple(axes)
    n = pos.size(axes)
    return _collective(
        pos, vals, axes,
        lambda v: _exchange(pos, v, axes, "reduce-scatter",
                            lambda parts, i: _cut(_sum(parts), dim, n, i,
                                                  sizes).contiguous()),
        lambda c: all_gather(pos, c, axes, dim))


def all_to_all(pos: Positions, vals: list, axes: Sequence[str],
               split_dim: int, concat_dim: int) -> list:
    """Each part cut into the group's size along ``split_dim``; position
    ``i`` gets every member's ``i``-th piece, concatenated along
    ``concat_dim`` in part order.  Backward: the all-to-all back."""
    axes = tuple(axes)
    n = pos.size(axes)
    return _collective(
        pos, vals, axes,
        lambda v: _exchange(pos, v, axes, "all-to-all",
                            lambda parts, i: torch.cat(
                                [p.chunk(n, split_dim)[i] for p in parts],
                                concat_dim)),
        lambda c: all_to_all(pos, c, axes, concat_dim, split_dim))


def permute(pos: Positions, vals: list, axes: Sequence[str],
            shift: int = 1) -> list:
    """A ring shift: the group's ``i``-th position gets the part of its
    ``(i - shift)``-th.  Backward: the shift back."""
    axes = tuple(axes)
    n = pos.size(axes)
    return _collective(
        pos, vals, axes,
        lambda v: _exchange(pos, v, axes, "collective-permute",
                            lambda parts, i: parts[(i - shift) % n].clone()),
        lambda c: permute(pos, c, axes, -shift))


def enter(pos: Positions, vals: list, axes: Sequence[str]) -> list:
    """A value every position of the group holds whole, entering
    computation split over ``axes`` (Megatron's *f*): the identity
    forward; backward, the positions' partial cotangents all-reduced."""
    axes = tuple(axes)
    return _collective(pos, vals, axes, lambda v: v,
                       lambda c: all_reduce(pos, c, axes))


def share(pos: Positions, vals: list, axes: Sequence[str]) -> list:
    """A value each position of the group computes for the whole group
    (a copy, or its own stand-in for it), whose cotangent the positions
    split: the identity forward; backward, each cotangent over the
    group's size.  Nothing moves."""
    axes = tuple(axes)
    n = pos.size(axes)
    return _collective(pos, vals, axes, lambda v: v,
                       lambda c: [t / n for t in c])


# ---------------------------------------------------------------------------
# laid-out tensors
# ---------------------------------------------------------------------------

class Dist(NamedTuple):
    """A tensor of ``shape`` laid out by ``spec`` (one entry a dim): the
    pieces the program's positions hold, in ``Positions.ks`` order."""

    shape: torch.Size
    spec: tuple
    vals: list

    def layer(self, i: int) -> "Dist":
        """Layer ``i`` of a stacked leaf (its leading dim whole)."""
        return Dist(self.shape[1:], self.spec[1:], [v[i] for v in self.vals])


def _spec(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def relayout(pos: Positions, d: Dist, *want,
             copies: Sequence[str] = ()) -> list:
    """``d``'s pieces laid out by ``want`` instead: each dim whose axes
    change is all-gathered over its old axes (the DATA gathers first),
    then cut locally by the new ones.  A gather over axes all among
    ``copies`` (the computation after it is duplicated over them) takes
    :func:`all_gather`'s ``copies`` backward."""
    want = _spec(want, len(d.shape))
    data = set(shd.data_axes(pos.mesh))
    vals = d.vals
    moved = [i for i in range(len(d.shape))
             if _axes(d.spec[i]) and _axes(d.spec[i]) != _axes(want[i])]
    for i in sorted(moved, key=lambda i: not set(_axes(d.spec[i])) <= data):
        ax = _axes(d.spec[i])
        vals = all_gather(pos, vals, ax, i, copies=set(ax) <= set(copies))
    for i, w in enumerate(want):
        w = _axes(w)
        if not w or w == _axes(d.spec[i]):
            continue
        n = pos.size(w)
        if d.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(d.shape)} does not divide "
                             f"over {w} ({n})")
        size = d.shape[i] // n
        vals = [v.narrow(i, pos.part(k, w) * size, size)
                for k, v in zip(pos.ks, vals)]
    return vals


def _wshape(p: dict) -> torch.Size:
    """The shape of a dense dict's weight, int8 (``w_q``) or not."""
    return (p["w"] if "w" in p else p["w_q"]).shape


def _weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A position's weight piece as a tensor: an int8 ``{"w_q", "scale"}``
    piece dequantized as ``layers.dense`` does (float32 product with the
    scale, then ``dtype``), else the piece itself."""
    return dequantize_weight(w, dtype) if isinstance(w, dict) else w


def _rows(w, at: torch.Tensor):
    """Rows ``at`` (input dims) of a weight piece; an int8 piece keeps its
    per-output-channel scale."""
    if isinstance(w, dict):
        return {"w_q": w["w_q"][at], "scale": w["scale"]}
    return w[at]


def _cols(pw: dict, at: torch.Tensor) -> dict:
    """Columns ``at`` (output dims) of a dense dict's pieces: its weight
    (or ``w_q``), its scale and its bias."""
    return {name: t[..., at] for name, t in pw.items()}


def _head_cols(heads: torch.Tensor, hd: int,
               dims: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The projection columns of heads ``heads`` (``hd`` columns a
    head): dims ``dims`` of each (default all), head by head."""
    if dims is None:
        dims = torch.arange(hd, device=heads.device)
    return (heads[:, None] * hd + dims[None, :]).reshape(-1)


def query_sources(cfg, tp: int, rank: int, device) -> torch.Tensor:
    """The kv head each query head of model rank ``rank`` reads (query
    heads split over ``tp`` ranks, the kv heads not)."""
    n = cfg.n_heads // tp
    return torch.arange(rank * n, (rank + 1) * n, device=device) // (
        cfg.n_heads // cfg.n_kv_heads)


def padded_sources(cfg, tp: int, rank: int, device) -> torch.Tensor:
    """The kv head each padded cache head of model rank ``rank`` repeats:
    padded head ``j`` is kv head ``j // (kv_head_pad // n_kv_heads)``,
    the reference's consecutive repeat."""
    m = cfg.kv_head_pad // tp
    return torch.arange(rank * m, (rank + 1) * m, device=device) // (
        cfg.kv_head_pad // cfg.n_kv_heads)


def ring_slot(cfg, positions: torch.Tensor) -> torch.Tensor:
    """The cache slot a decode step writes for each row's position: the
    ring's ``pos % window`` under a sliding window, else ``pos``."""
    w = cfg.sliding_window
    return positions % w if w else positions


def write_slot(cache: torch.Tensor, slot: torch.Tensor,
               new: torch.Tensor) -> None:
    """``new`` (B, ...) written in place at each row's ``slot`` of
    ``cache`` (B, S, ...)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new.to(cache.dtype)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class _Program:
    """One partitioned prefill or decode of ``cfg`` over ``pos``."""

    def __init__(self, cfg, pos: Positions):
        self.cfg, self.pos = cfg, pos
        mesh = pos.mesh
        self.M = "model" if "model" in mesh.axis_names else None
        self.tp = mesh.shape["model"] if self.M else 1
        self.bax: Tuple[str, ...] = ()
        # the rows of the batch each part of bax holds, where a train
        # step's microbatch splits unevenly (None: equal parts)
        self.shares: Optional[List[int]] = None
        self.mode = "heads"

    # -- helpers ------------------------------------------------------------

    def map(self, fn, *args):
        return self.pos.map(fn, *args)

    def fetch(self, d: Dist, *want, split: Optional[bool] = None) -> list:
        """``d``'s pieces laid out by ``want`` for a computation split
        over ``model`` where ``split`` (default: where ``want`` names
        ``model``), else duplicated over it.  Under autograd a leaf whole
        over ``model`` entering split computation goes through
        :func:`enter`, and a gather over ``model`` feeding duplicated
        computation takes the ``copies`` backward."""
        m = _axes(self.M)
        if split is None:
            split = any(self.M in _axes(w) for w in want)
        if split and m and not any(self.M in _axes(a) for a in d.spec):
            d = Dist(d.shape, d.spec, enter(self.pos, d.vals, m))
        return relayout(self.pos, d, *want, copies=() if split else m)

    def enter(self, vals: list) -> list:
        """Activations every ``model`` rank holds whole, entering
        computation split over ``model`` (:func:`enter`)."""
        return enter(self.pos, vals, _axes(self.M))

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` splits over ``model``."""
        return self.tp > 1 and n % self.tp == 0

    def model_sum(self, vals: list) -> list:
        return all_reduce(self.pos, vals, _axes(self.M))

    def rank(self, k: int) -> int:
        return self.pos.part(k, _axes(self.M))

    def wfetch(self, w, *want, split: Optional[bool] = None) -> list:
        """Each position's piece of a weight laid out by ``want``, as
        :meth:`fetch` gives it: ``w`` a leaf, a dense dict (its ``"w"``)
        or an int8 weight (``{"w_q", "scale"}``, a dense dict's or a MoE
        stack's), whose per-output-channel scale follows the weight's
        last dim (the reference's rule): then a ``{"w_q", "scale"}`` dict
        of the pieces a position, dequantized where it is used
        (``layers.dense``, :func:`_weight`)."""
        if isinstance(w, Dist):
            return self.fetch(w, *want, split=split)
        if "w_q" not in w:
            return self.fetch(w["w"], *want, split=split)
        want = _spec(want, len(w["w_q"].shape))
        if split is None:
            split = any(self.M in _axes(a) for a in want)
        q = self.fetch(w["w_q"], *want, split=split)
        s = self.fetch(w["scale"], *want[:-2], want[-1], split=split)
        return [{"w_q": a, "scale": b} for a, b in zip(q, s)]

    def local(self, p: dict, *want, split: Optional[bool] = None) -> list:
        """Each position's dense ``p`` laid out by ``want`` (the weight's
        spec; the bias follows its output dim), as ``{"w", "b"}`` dicts
        (``{"w_q", "scale", "b"}`` for an int8 weight); ``split`` as
        :meth:`fetch` takes it."""
        out = [dict(w) if isinstance(w, dict) else {"w": w}
               for w in self.wfetch(p, *want, split=split)]
        if "b" in p:
            for o, b in zip(out, self.fetch(p["b"], want[-1], split=split)):
                o["b"] = b
        return out

    def dense(self, p: dict, x: list, *want) -> list:
        return self.map(dense, self.local(p, *want), x)

    def row(self, p: dict, x: list, w: list) -> list:
        """A row-parallel dense of ``x`` (its input dim on ``model``) by
        the pieces ``w`` of ``p``'s weight (int8 pieces dequantized to
        ``x``'s dtype first): each position's partial in float32, added
        over ``model`` and rounded once to ``x``'s dtype, as the whole
        product rounds once; ``p["b"]`` added after."""
        out = self.map(lambda h, w: (h.to(torch.float32) @ _weight(
            w, h.dtype).to(torch.float32)), x, w)
        out = self.map(lambda o, h: o.to(h.dtype), self.model_sum(out), x)
        if "b" in p:
            out = self.map(torch.add, out, self.fetch(p["b"], None))
        return out

    # -- layers --------------------------------------------------------------

    def embed(self, emb: Dist, ids: list) -> list:
        v = emb.shape[0]
        if not self.splits(v):
            return self.map(lambda w, i: w[i], self.fetch(emb, None, None),
                            ids)
        n = v // self.tp

        def look(w, i, k):
            lo = self.rank(k) * n
            hit = (i >= lo) & (i < lo + n)
            return torch.where(hit[..., None], w[(i - lo).clamp(0, n - 1)],
                               0)

        local = self.map(look, self.fetch(emb, self.M, None), ids,
                         list(self.pos.ks))
        return self.model_sum(local)

    def norm(self, p: dict, x: list) -> list:
        eps = self.cfg.norm_eps
        return self.map(lambda g, h: rmsnorm({"g": g}, h, eps),
                        self.fetch(p["g"], None), x)

    def frontend(self, fp: dict, x: list) -> list:
        """The modality stub's projection of each position's rows ``x``
        (column-parallel, its output gathered over ``model``: every rank
        then holds the whole ``d_model``, and its cotangent is its own
        part)."""
        split = self.splits(_wshape(fp)[1])
        out = self.dense(fp, x, None, self.M if split else None)
        if split:
            out = all_gather(self.pos, out, _axes(self.M), 2, copies=True)
        return out

    def mlp(self, p: dict, h: list) -> list:
        """The MLP, its hidden dim on ``model`` where it splits; the PuM
        MLP's integer relu stage on each position's own ``up`` slice."""
        split = self.splits(_wshape(p["up"])[1])
        ax = self.M if split else None
        cfg = self.cfg
        if cfg.pum != "off" and cfg.act == "relu":
            # the integer stage cuts the gradient: nothing flows back
            # into h through up, so it needs no enter
            hidden = self.map(
                lambda h, pu: pum_relu_hidden(dense(pu, h), cfg.pum_bits),
                h, self.local(p["up"], None, ax))
        else:
            names = [n for n in ("up", "gate") if n in p]
            if split:
                h = self.enter(h)
            hidden = self.map(
                lambda h, *ps: mlp_hidden(dict(zip(names, ps)), h, cfg.act),
                h, *(self.local(p[n], None, ax) for n in names))
        if not split:
            return self.dense(p["down"], hidden, None, None)
        return self.row(p["down"], hidden, self.wfetch(p["down"], self.M,
                                                       None))

    def attention(self, p: dict, h: list, positions: list, cache: list,
                  idx: list, memory: Optional[list] = None,
                  causal: bool = True) -> list:
        """Self-attention of the normed ``h`` (causal or not) in the
        program's mode, writing ``cache`` where decode gives one; or,
        given ``memory`` (each position's rows of the encoder's output),
        the cross-attention over it in :func:`_cross_mode`'s layout."""
        cfg = self.cfg
        mode = self.mode if memory is None else _cross_mode(cfg, self.tp)
        if mode == "hd":
            return self._attention_hd(p, h, positions, cache, idx, causal)
        split = mode != "full" and self.tp > 1
        n = self.tp if split else 1
        ax = self.M if split else None
        if split:
            h = self.enter(h)
            if memory is not None:
                memory = self.enter(memory)
        q = self.local(p["q"], None, ax)
        padded = (memory is None and cache[0] is not None
                  and cfg.kv_head_pad > cfg.n_kv_heads)
        if mode == "qheads" or (padded and mode == "heads"):
            # each rank's query heads (or padded cache heads) against the
            # kv heads they read, as columns of the gathered k and v
            # weights (one set a query or padded head)
            sources = query_sources if mode == "qheads" else padded_sources
            kv = [self.map(
                lambda pw, k: _cols(pw, _head_cols(sources(
                    cfg, self.tp, self.rank(k), _device(pw)), cfg.hd)),
                self.local(p[name], None, None, split=True),
                list(self.pos.ks)) for name in ("k", "v")]
            n_kv = (cfg.n_heads if mode == "qheads" else cfg.kv_head_pad) // n
        else:
            kv = [self.local(p[name], None, ax) for name in ("k", "v")]
            n_kv = cfg.n_kv_heads // n
        pad = cfg.kv_head_pad if mode == "full" else 0

        def one(h, t, c, i, m, pq, pk, pv):
            return attention_heads(
                {"q": pq, "k": pk, "v": pv}, h, t, n_heads=cfg.n_heads // n,
                n_kv=n_kv, hd=cfg.hd, rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window,
                cache=c, cache_index=i, memory=m, causal=causal,
                kv_head_pad=pad)[0]

        out = self.map(one, h, positions, cache, idx,
                       memory or self.pos.same(None), q, *kv)
        if not split:
            return self.dense(p["o"], out, None, None)
        return self.row(p["o"], out, self.wfetch(p["o"], self.M, None))

    def _attention_hd(self, p, h, positions, cache, idx,
                      causal: bool = True) -> list:
        """Attention with ``head_dim`` split over ``model``: position of
        model rank ``r`` computes dims ``[r·d, (r+1)·d)`` of every head
        (``d = hd / tp``), its RoPE from the partner dims, a partial
        ``q·k`` over its dims (all-reduced in float32), and ``p·v`` and
        the output projection's partial over its dims (all-reduced).  A
        padded cache gets each fresh kv head repeated into its padded
        heads; an int8 one the fresh entries quantized with the scale of
        the whole row, whose amax the ranks agree on first
        (:func:`all_max`)."""
        cfg = self.cfg
        hd, nh, n_kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        d, half = hd // self.tp, hd // 2
        win = cfg.sliding_window
        cached = cache[0] is not None
        g = cache[0]["k"].shape[2] if cached else n_kv
        quant = cached and cache[0]["k"].dtype == torch.int8
        h = self.enter(h)
        full = [self.local(p[name], None, None, split=True)
                for name in ("q", "k", "v")]
        wo = self.wfetch(p["o"], None, None, split=True)
        scale = _scale(hd)

        def cols(n_heads, dims):
            return _head_cols(torch.arange(n_heads, device=dims.device), hd,
                              dims)

        def project_all(hx, t, k, pq, pk, pv):
            b, l, _ = hx.shape
            own = torch.arange(self.rank(k) * d, (self.rank(k) + 1) * d,
                               device=hx.device)
            partner = (own + half) % hd

            def project(pw, n_heads, dims):
                return dense(_cols(pw, cols(n_heads, dims)), hx).reshape(
                    b, l, n_heads, -1)

            cos, sin = rope_angles(t, hd, cfg.rope_theta)
            cos = cos[..., own % half][..., None, :]
            sin = sin[..., own % half][..., None, :]
            sign = torch.where(own < half, -1.0, 1.0)

            def rope(pw, n_heads):
                x = project(pw, n_heads, torch.cat([own, partner]))
                xa, xb = x[..., :d], x[..., d:]
                dt = xa.dtype
                return xa * cos.to(dt) + (xb * sin.to(dt)) * sign.to(dt)

            kk, v = rope(pk, n_kv), project(pv, n_kv, own)
            if g > n_kv:
                kk = torch.repeat_interleave(kk, g // n_kv, dim=2)
                v = torch.repeat_interleave(v, g // n_kv, dim=2)
            return rope(pq, nh), kk, v, own

        projected = self.map(project_all, h, positions, list(self.pos.ks),
                             *full)
        amax = self.pos.same(None)
        if quant:
            # each rank's amax over its slice of every fresh row, then the
            # whole row's at every rank
            amax = all_max(self.pos, self.map(lambda r: torch.stack([
                torch.amax(torch.abs(x.to(torch.float32)), dim=-1)
                for x in r[1:3]]), projected), _axes(self.M))

        def first(r, t, c, i, am):
            q, kk, v, own = r
            b, l = q.shape[:2]
            qf = q.to(torch.float32)
            if c is None and causal and win and l > win and l % win == 0:
                # the reference's banded form: query block i against key
                # blocks i-1 and i
                nb = l // win
                part = torch.einsum("bnwgrh,bnsgh->bngrws",
                                    qf.reshape(b, nb, win, g, nh // g, d),
                                    band_pairs(kk.to(torch.float32), nb,
                                               win))
                return part, (band_mask(nb, win, q.device),
                              band_pairs(v, nb, win), q.dtype, own)
            if c is None:
                kc, vc = kk, v
                qpos, kpos = t[:, :, None], t[:, None, :]
                mask = torch.ones((b, l, l), dtype=torch.bool,
                                  device=q.device)
                if causal:
                    mask = mask & (kpos <= qpos)
                if win:
                    mask = mask & (kpos > qpos - win)
            else:
                slot = i[:, 0]
                if quant:
                    for name, x, a in (("k", kk, am[0]), ("v", v, am[1])):
                        xq, xs = quantize_kv(x, a)
                        write_slot(c[name], slot, xq[:, 0])
                        write_slot(c[f"{name}_scale"], slot, xs[:, 0])
                    kc, vc = ((c[name].to(torch.float32)
                               * c[f"{name}_scale"][..., None]).to(q.dtype)
                              for name in ("k", "v"))
                else:
                    write_slot(c["k"], slot, kk[:, 0])
                    write_slot(c["v"], slot, v[:, 0])
                    kc, vc = c["k"], c["v"]
                s = kc.shape[1]
                slots = torch.arange(s, device=q.device)[None, :]
                cur = t[:, 0][:, None]
                if win:
                    # the ring: each slot's age, the oldest dropped
                    valid = cur - (slot[:, None] - slots) % s >= 0
                else:
                    valid = slots <= cur
                mask = valid[:, None, :].expand(b, l, s)
            qg = qf.reshape(b, l, g, nh // g, d)
            part = torch.einsum("blgrh,bsgh->bgrls", qg,
                                kc.to(torch.float32))
            return part, (mask[:, None, None], vc, q.dtype, own)

        def second(score, rest):
            mask, vc, dt, own = rest
            logits = score.to(dt).to(torch.float32) * scale
            logits = torch.where(mask, logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(vc.dtype)
            if score.dim() == 6:
                out = torch.einsum("bngrws,bnsgh->bnwgrh", probs, vc)
            else:
                out = torch.einsum("bgrls,bsgh->blgrh", probs, vc)
            return out.reshape(out.shape[0], -1, nh * d)

        firsts = self.map(first, projected, positions, cache, idx, amax)
        # the summed scores (every rank's whole) meet each rank's own
        # value dims in p.v: enter, so their cotangent sums the ranks'
        scores = self.enter(self.model_sum([s for s, _ in firsts]))
        out = self.map(second, scores, [r for _, r in firsts])
        rows = self.map(lambda w, rest: _rows(w, cols(nh, rest[3])), wo,
                        [r for _, r in firsts])
        return self.row(p["o"], out, rows)

    def moe(self, p: dict, h: list) -> list:
        """The MoE FFN: ``moe_forward_ep`` over each ``model`` group, its
        experts on ``model`` (a trace of one position runs what that
        position runs there: its experts' dispatch, then the psum)."""
        cfg, pos = self.cfg, self.pos
        if cfg.moe_impl == "dense":
            return self.moe_dense(p, h)[0]
        n_e = p["router"].shape[1]
        split = self.splits(n_e)
        whole = cfg.moe_impl != "ep"
        x = all_gather(pos, h, self.bax, 0) if whole else h
        ax = self.M if split else None
        w = {name: self.wfetch(p[name], ax, None, None)
             for name in ("up", "gate", "down") if name in p}
        w["router"] = self.fetch(p["router"], None, None)
        if pos.meta:
            out = self.map(functools.partial(self._moe_rank, n_e, split,
                                             list(w)),
                           x, list(pos.ks), *w.values())
            if split:
                out = self.model_sum(out)
        else:
            out = self._moe_ep(x, w, p, split)
        if whole and self.bax:
            n = pos.size(self.bax)
            out = [o.narrow(0, pos.part(k, self.bax) * (o.shape[0] // n),
                            o.shape[0] // n) for k, o in zip(pos.ks, out)]
        return out

    def moe_dense(self, p: dict, h: list, aux: bool = False
                  ) -> Tuple[list, Optional[list]]:
        """The dense MoE FFN (``moe_impl="dense"``, the reference's
        ``moe_forward``: every expert over every token, mask-combined) on
        each position's rows ``h``, and (``aux``) its load-balance aux.
        Dense dispatch has no capacity, so no rows are gathered: the
        routing is a copy at every ``model`` rank, each rank runs its own
        experts (E on ``model`` where it splits) weighted by the combine
        weights of those experts, and the float32 partials are summed
        over ``model`` and rounded once.  The aux is ``n_e · Σ f_e p_e``
        over the global batch: the per-expert sums of the one-hots and
        the probabilities all-reduced over the batch axes, then divided
        (serving leaves it out, as the reference's compiled steps drop
        it).  Under autograd the rows and the top-k weights enter the
        split computation through :func:`enter`."""
        cfg, pos = self.cfg, self.pos
        n_e = p["router"].shape[1]
        top_k = cfg.experts_per_token
        split = self.splits(n_e)
        e_loc = n_e // self.tp if split else n_e
        ax = self.M if split else None
        names = [n for n in ("up", "gate", "down") if n in p]
        ws = [self.wfetch(p[n], ax, None, None) for n in names]
        probs, topv, topi = (list(z) for z in zip(*self.map(
            lambda x, r: moe._route({"router": r}, x, top_k), h,
            self.fetch(p["router"], None, None))))
        xs, tv = (self.enter(h), self.enter(topv)) if split else (h, topv)

        def experts(x, v, i, k, *w):
            lo = self.rank(k) * e_loc if split else 0
            onehot = F.one_hot(i, n_e).to(torch.float32)[..., lo:lo + e_loc]
            comb = torch.einsum("blk,blke->ble", v, onehot)
            pw = dict(zip(names, w))
            up = torch.einsum("bld,edf->blef", x,
                              effective_weight(pw["up"], x.dtype))
            g = (torch.einsum("bld,edf->blef", x,
                              effective_weight(pw["gate"], x.dtype))
                 if "gate" in pw else None)
            out = torch.einsum("blef,efd->bled", moe._act(up, g, cfg.act),
                               effective_weight(pw["down"], x.dtype))
            # the reference rounds the combine weights to the outputs'
            # dtype; the sum over experts is float32 until model_sum's
            return torch.einsum("bled,ble->bld", out.to(torch.float32),
                                comb.to(out.dtype).to(torch.float32))

        out = self.map(experts, xs, tv, topi, list(pos.ks), *ws)
        if split:
            out = self.model_sum(out)
        out = self.map(lambda o, x: o.to(x.dtype), out, h)
        if not aux:
            return out, None
        sums = all_reduce(pos, self.map(lambda pr, i: torch.stack([
            F.one_hot(i, n_e).to(torch.float32).sum((0, 1, 2)),
            pr.sum((0, 1))]), probs, topi), self.bax)
        rows = sum(self.shares) if self.shares else \
            h[0].shape[0] * pos.size(self.bax)
        n_tok = rows * h[0].shape[1]
        return out, self.map(
            lambda s: n_e * torch.sum((s[0] / n_tok) * (s[1] / n_tok)), sums)

    def _moe_rank(self, n_e, split, names, x, k, *ws):
        """What ``moe_forward_ep`` runs at model rank ``k``'s position on
        one data shard: the dispatch to its own experts."""
        b, l, d = x.shape
        top_k = self.cfg.experts_per_token
        e_loc = n_e // self.tp if split else n_e
        e_lo = self.rank(k) * e_loc if split else 0
        cap = max(1, int(1.25 * b * l * top_k / n_e))
        out, _ = moe._grouped_local(
            dict(zip(names, ws)), x.reshape(b * l, d), top_k=top_k,
            act=self.cfg.act, cap=cap, e_lo=e_lo, e_loc=e_loc)
        return out.reshape(b, l, d)

    def _moe_ep(self, x: list, w: dict, p: dict, split: bool) -> list:
        """``moe_forward_ep`` once a ``model`` group, over a mesh of the
        group's positions (their devices and streams), its weights the
        positions' pieces ``w`` of ``p``'s leaves (an int8 stack's
        ``w_q`` and scale each a piece); the sum it returns at the
        group's first position is copied to the others (the psum's
        result on every rank)."""
        pos, cfg = self.pos, self.cfg
        out: list = [None] * len(pos.ks)
        for k in pos.ks:
            members = pos.group(k, _axes(self.M))
            if members[0] != k:
                continue
            at = [pos._index[m] for m in members]
            sub = Mesh((1, len(at)), ("data", "model"),
                       [pos.devs[i] for i in at])
            sub._streams = {j: pos.streams[i] for j, i in enumerate(at)
                            if pos.streams[i] is not None}

            def piece(d: Dist, t: list, spec):
                if not split:
                    return t[at[0]]
                return shd.Sharded(d.shape, t[at[0]].dtype,
                                   shd.Sharding(sub, shd.P(spec)),
                                   [t[i] for i in at])

            p_sub = {}
            for name, t in w.items():
                spec = None if name == "router" else "model"
                p_sub[name] = {leaf: piece(p[name][leaf], [u[leaf] for u in t],
                                           spec) for leaf in t[0]} \
                    if isinstance(t[0], dict) else piece(p[name], t, spec)
            i0 = at[0]
            with on_stream(pos.devs[i0], pos.streams[i0]):
                y, _ = moe.moe_forward_ep(p_sub, x[i0],
                                          top_k=cfg.experts_per_token,
                                          act=cfg.act, mesh=sub)
                done = mark(pos.streams[i0])
            out[i0] = y
            for i in at[1:]:
                with on_stream(pos.devs[i], pos.streams[i]):
                    wait_for(pos.streams[i], done)
                    out[i] = read_on(y, pos.streams[i]).to(pos.devs[i],
                                                           copy=True)
            if split:
                for ledger in _LEDGERS.get():
                    ledger.charge("all-reduce", _nbytes(y), _nbytes(y))
        return out

    def mix(self, p: dict, h: list, positions: list, cache: list,
            idx: list, causal: bool = True) -> list:
        """The block's sequence mixer on the normed ``h``: attention, the
        SSM, or (a hybrid block) their sum.  ``cache`` is each position's
        layer caches (None without), which decode writes: attention's in
        place, the SSM's new state copied in."""
        out = None
        if "attn" in p:
            out = self.attention(p["attn"], h, positions, [
                None if c is None else c["attn"] for c in cache], idx,
                causal=causal)
        if "ssm" in p:
            from .partition_ssm import mixer
            s, new = mixer(self, p["ssm"], h, [
                None if c is None else c["ssm"] for c in cache])
            for c, n in zip(cache, new or ()):
                tree_map(lambda old, t: old.copy_(t), c["ssm"], n)
            out = s if out is None else self.map(torch.add, out, s)
        return out

    def cross(self, p: dict, x: list, memory: Optional[list]) -> list:
        """A decoder block's cross-attention over ``memory`` added to the
        residual ``x`` (``x`` itself without a memory or an ``xattn``)."""
        if "xattn" not in p or memory is None:
            return x
        none = self.pos.same(None)
        out = self.attention(p["xattn"], self.norm(p["ln_x"], x), none,
                             none, none, memory=memory)
        return self.map(torch.add, x, out)

    def block(self, p: dict, x: list, positions: list, cache: list,
              idx: list, memory: Optional[list] = None,
              causal: bool = True) -> list:
        h = self.norm(p["ln1"], x)
        x = self.map(torch.add, x, self.mix(p, h, positions, cache, idx,
                                            causal))
        x = self.cross(p, x, memory)
        if "ln2" not in p:
            return x
        h2 = self.norm(p["ln2"], x)
        ff = self.moe(p["moe"], h2) if "moe" in p else None
        if "mlp" in p:
            m = self.mlp(p["mlp"], h2)
            ff = m if ff is None else self.map(torch.add, ff, m)
        return self.map(torch.add, x, ff)

    def readout(self, params: dict, x: list) -> Tuple[list, tuple]:
        """Logits of ``x`` and their layout: vocab on ``model`` where it
        splits."""
        if self.cfg.tie_embeddings:
            emb = params["embed"]["emb"]
            ax = self.M if self.splits(emb.shape[0]) else None
            out = self.map(lambda w, h: unembed({"emb": w}, h),
                           self.fetch(emb, ax, None),
                           self.enter(x) if ax else x)
        else:
            ax = self.M if self.splits(_wshape(params["out"])[1]) else None
            out = self.dense(params["out"], self.enter(x) if ax else x, None,
                             ax)
        return out, (self.bax, ax)

    # -- the steps -------------------------------------------------------------

    def blocks(self, blocks: dict, ln: dict, x: list, positions: list,
               caches, idx, memory: Optional[list] = None,
               causal: bool = True) -> list:
        """The stack ``blocks`` (each layer's caches from ``caches``
        where decode gives them), then the final norm ``ln``."""
        n_layers = next(tree_leaves(blocks)).shape[0]
        for i in range(n_layers):
            lp = tree_map(lambda d: d.layer(i), blocks)
            lc = self.pos.same(None) if caches is None else [
                tree_map(lambda t: t[i], c) for c in caches]
            x = self.block(lp, x, positions, lc, idx, memory, causal)
        return self.norm(ln, x)

    def _positions(self, x: list) -> list:
        """Positions ``0..l-1`` of each position's rows ``x`` (B, l, ...)."""
        return self.map(lambda t: torch.arange(
            t.shape[1], dtype=torch.int32, device=t.device)[None].expand(
                *t.shape[:2]), x)

    def encode(self, params: dict, feats: list) -> list:
        """The encoder over each position's rows of ``encoder_feats``:
        the stub's projection, the bidirectional ``enc_blocks`` and
        ``enc_ln_f``; the memory every decoder block reads."""
        if self.cfg.frontend:
            feats = self.frontend(params["frontend_proj"], feats)
        return self.blocks(params["enc_blocks"], params["enc_ln_f"], feats,
                           self._positions(feats), None, self.pos.same(None),
                           causal=False)

    def prefill(self, params: dict, tokens: Dist, vision: Optional[Dist],
                feats: Optional[Dist] = None) -> Tuple[list, tuple]:
        data = shd.data_axes(self.pos.mesh)
        self.bax = _axes(tokens.spec[0])
        if not set(self.bax) <= set(data):
            self.bax = _axes(shd._fit(self.pos.mesh, tokens.shape[0], data))
        cfg = self.cfg
        self.mode = _attention_mode(cfg, self.tp)
        if self.mode != "heads" and cfg.n_heads % self.tp == 0:
            # no cache to keep in its layout: split the query heads, not
            # head_dim, whose partial scores grow with the square of the
            # sequence
            self.mode = "qheads"
        ids = self.fetch(tokens, self.bax, None)
        memory = None
        if cfg.is_encdec:
            memory = self.encode(params,
                                 self.fetch(feats, self.bax, None, None))
        x = self.embed(params["embed"]["emb"], ids)
        positions = self._positions(ids)
        if vision is not None:
            ve = self.frontend(params["frontend_proj"],
                               self.fetch(vision, self.bax, None, None))
            x = self.map(lambda v, h: torch.cat([v.to(h.dtype), h], dim=1),
                         ve, x)
            vp = vision.shape[1]
            positions = self.map(lambda t: torch.cat([torch.arange(
                vp, dtype=torch.int32, device=t.device)[None].expand(
                    t.shape[0], vp), t + vp], dim=1), positions)
        x = self.blocks(params["blocks"], params["ln_f"], x, positions, None,
                        self.pos.same(None), memory)
        logits, spec = self.readout(params, self.map(
            lambda h: h[:, -1:, :], x))
        return self.map(lambda t: t[:, 0, :], logits), _spec(spec, 2)

    def decode(self, params: dict, caches: dict, token: Dist, pos_: Dist,
               memory: Optional[Dist] = None) -> Tuple[list, tuple, dict]:
        """(logits, their spec, the new caches as a tree of
        :class:`Dist` in the layout decode computed them in)."""
        caches = self.relay_caches(caches)
        self.bax = self._cache_layout(caches)
        ids = self.fetch(token, self.bax)
        at = self.fetch(pos_, self.bax)
        x = self.map(lambda i: i[:, None], self.embed(
            params["embed"]["emb"], ids))
        positions = self.map(lambda t: t[:, None], at)
        cloned = tree_map(lambda d: self.map(torch.clone, d.vals), caches)
        new = [tree_map(lambda v: v[i], cloned)
               for i in range(len(self.pos.ks))]
        idx = self.map(lambda t: ring_slot(self.cfg, t), positions)
        mem = None if memory is None else self.fetch(memory, self.bax, None,
                                                     None)
        x = self.blocks(params["blocks"], params["ln_f"], x, positions, new,
                        idx, mem)
        logits, spec = self.readout(params, x)
        return self.map(lambda t: t[:, 0, :], logits), _spec(spec, 2), \
            tree_map(lambda d, *vals: Dist(d.shape, d.spec, list(vals)),
                     caches, *new)

    def relay_caches(self, caches: dict) -> dict:
        """``caches`` in ``cache_shardings``' layout, the one decode
        computes on: each leaf laid out otherwise gathered over its old
        axes and cut by the new ones (:func:`relayout`, its gathers
        charged; a replicated leaf is only cut)."""
        want = shd.cache_shardings(tree_map(_Like, caches), self.pos.mesh)

        def one(d: Dist, sh) -> Dist:
            spec = _spec(sh.spec, len(d.shape))
            return d if d.spec == spec else Dist(
                d.shape, spec, relayout(self.pos, d, *spec))

        return tree_map(one, caches, want)

    def _cache_layout(self, caches: dict) -> Tuple[str, ...]:
        """The batch axes of ``caches`` in ``cache_shardings``' layout;
        sets attention's mode from the kv cache's (its heads, else its
        ``head_dim``, over ``model``, else neither)."""
        if "attn" in caches:
            ax = [_axes(a) for a in caches["attn"]["k"].spec]
            self.mode = "heads" if ax[3] or self.tp == 1 else \
                "hd" if ax[4] else "full"
            return ax[1]
        return _axes(caches["ssm"]["ssm"].spec[1])


class _Like:
    """A leaf's shape for the sharding rules, with no tensor made: a
    trace on ``meta`` counts every tensor an op makes."""

    def __init__(self, d: Dist):
        self.shape = d.shape

    def dim(self) -> int:
        return len(self.shape)


def _device(pw: dict) -> torch.device:
    return next(iter(pw.values())).device


def _attention_mode(cfg, tp: int, cache: bool = False) -> str:
    """How attention splits over ``model`` (cache_shardings' choice):
    by heads where the kv heads divide, else by ``head_dim``, else not.
    A decode ``cache`` holds ``max(n_kv_heads, kv_head_pad)`` heads (the
    padded ones), as ``init_caches`` makes it."""
    g = max(cfg.n_kv_heads, cfg.kv_head_pad) if cache else cfg.n_kv_heads
    if tp == 1 or g % tp == 0:
        return "heads"
    return "hd" if cfg.hd % tp == 0 else "full"


def _cross_mode(cfg, tp: int) -> str:
    """How cross-attention splits over ``model``: by kv heads where they
    divide, else by query heads (each rank projecting the memory's kv
    heads its query heads read), else whole.  It keeps no cache, so no
    layout binds it."""
    if tp == 1 or cfg.n_kv_heads % tp == 0:
        return "heads"
    return "qheads" if cfg.n_heads % tp == 0 else "full"


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

_PREFILL = make_prefill(None).__wrapped__.__code__
_DECODE = make_serve_step(None).__wrapped__.__code__
_TRAIN = next(c for c in make_train_step.__code__.co_consts
              if inspect.iscode(c) and c.co_name == "train_step")


def _cells(fn) -> dict:
    """The names and values of ``fn``'s closure."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


def _recognise(step) -> Tuple[str, dict]:
    """The kind of ``step`` and its closure: ``cfg`` for every kind, and
    for a train step ``ocfg``, ``n_microbatches``, ``grad_transform``,
    ``remat`` and ``unroll``."""
    if getattr(step, "__code__", None) is _TRAIN:
        cells = _cells(step)
        cells.update(_cells(_cells(cells["value_and_grad"])["loss_fn"]))
        return "train", cells
    fn = getattr(step, "__wrapped__", None)
    code = getattr(fn, "__code__", None)
    if code is not _PREFILL and code is not _DECODE:
        raise ValueError(f"partitioned_step takes a step of make_prefill or "
                         f"make_serve_step (or make_train_step), not "
                         f"{step!r}")
    return ("prefill" if code is _PREFILL else "decode"), _cells(fn)


class PartitionedStep:
    """A prefill or decode step partitioned over the mesh of its
    shardings (see :func:`partitioned_step`)."""

    def __init__(self, step, in_shardings, out_shardings):
        self.kind, self.closure = _recognise(step)
        self.cfg = self.closure["cfg"]
        self.names = list(inspect.signature(step).parameters)
        self.in_shardings = tuple(in_shardings)
        if len(self.in_shardings) > len(self.names):
            raise ValueError(f"{len(self.in_shardings)} in_shardings for "
                             f"the {len(self.names)} arguments of the step")
        self.out_shardings = out_shardings
        first = shd._first_sharding(self.in_shardings)
        if first is None:
            raise ValueError("partitioned_step needs a Sharding among its "
                             "in_shardings")
        self.mesh = first.mesh

    def _bind(self, args, kwargs) -> dict:
        bound = dict(zip(self.names, args))
        bound.update(kwargs)
        unknown = set(bound) - set(self.names)
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        return bound

    def _dists(self, bound: dict, make: Callable) -> dict:
        """Each argument's leaves as :class:`Dist`, ``make(leaf,
        sharding)`` (a sharding of None: replicated)."""
        out = {}
        for name, value in bound.items():
            i = self.names.index(name)
            sh = self.in_shardings[i] if i < len(self.in_shardings) else None
            out[name] = None if value is None else shd.tree_map_with_path(
                lambda path, leaf: make(leaf, shd._sharding_at(sh, path)
                                        or shd.replicated(self.mesh)),
                value)
        return out

    def _run(self, pos: Positions, dists: dict):
        """(logits, their spec, new caches or None) at ``pos``."""
        prog = _Program(self.cfg, pos)
        with torch.no_grad():
            if self.kind == "prefill":
                return prog.prefill(dists["params"], dists["tokens"],
                                    dists.get("vision_embeds"),
                                    dists.get("encoder_feats")) + (None,)
            return prog.decode(dists["params"], dists["caches"],
                               dists["token"], dists["pos"],
                               dists.get("memory"))

    def _out_sharding(self, i: int):
        o = self.out_shardings
        if isinstance(o, (tuple, list)):
            return o[i] if i < len(o) else None
        return o if i == 0 else None

    def __call__(self, *args, **kwargs):
        """The step over the mesh: arguments laid out by ``in_shardings``
        (:class:`Sharded` leaves, or whole tensors, which are cut first),
        outputs laid out by ``out_shardings`` (an entry of None gives a
        whole tensor on the first position's device)."""
        pos = Positions(self.mesh, range(self.mesh.size))
        dists = self._dists(self._bind(args, kwargs), self._placed)
        logits, spec, new = self._run(pos, dists)
        out = self._out(pos, Dist(_shape(logits, spec, pos), spec, logits),
                        self._out_sharding(0))
        if new is None:
            return out
        cs = self._out_sharding(1)
        return out, {group: {
            name: self._out(pos, d, None if cs is None
                            else shd._sharding_at(cs, (group, name)))
            for name, d in leaves.items()}
            for group, leaves in new.items()}

    def _placed(self, leaf, sh) -> Dist:
        """An argument's leaf as the pieces its sharding ``sh`` lays out
        (a :class:`Sharded` of another layout, or a whole tensor, cut
        anew)."""
        if sh.mesh is not self.mesh:
            raise ValueError(f"a sharding over {sh.mesh!r}, not the step's "
                             f"{self.mesh!r}")
        if not (isinstance(leaf, shd.Sharded) and leaf.sharding == sh):
            leaf = shd.place(leaf if isinstance(leaf, shd.Sharded)
                             else torch.as_tensor(leaf), sh)
        vals = list(leaf.shards) if isinstance(leaf, shd.Sharded) else [leaf]
        return Dist(leaf.shape, _spec(sh.spec, len(leaf.shape)), vals)

    def _out(self, pos: Positions, d: Dist, sh):
        target = sh if sh is not None else shd.replicated(self.mesh)
        vals = relayout(pos, d, *_spec(target.spec, len(d.shape)))
        pos.join(vals)
        if self.mesh.size == 1:
            return vals[0]
        out = shd.Sharded(d.shape, vals[0].dtype, target, vals)
        return out if sh is not None else out.gather(pos.devs[0])

    # -- one position on meta -------------------------------------------------

    def local_arguments(self, *args, **kwargs) -> dict:
        """A position's pieces of whole ``meta`` arguments: empty ``meta``
        tensors of its shard shapes (every position's are the same)."""

        def make(leaf, sh):
            spec = _spec(sh.spec, leaf.dim())
            return Dist(leaf.shape, spec, [torch.empty(
                shd.Sharding(self.mesh, spec).shard_shape(leaf.shape),
                dtype=leaf.dtype, device="meta")])

        return self._dists(self._bind(args, kwargs), make)

    def run_position(self, local: dict, position: int = 0):
        """Position ``position``'s program alone on ``meta``, over the
        pieces :meth:`local_arguments` gave: its logits and (decode) its
        new caches, as that position holds them."""
        pos = Positions(self.mesh, [position], meta=True)
        logits, spec, new = self._run(pos, local)
        target = self._out_sharding(0)
        want = target.spec if target is not None else ()
        logits = relayout(pos, Dist(_shape(logits, spec, pos), spec, logits),
                          *_spec(want, 2))[0]
        return logits if new is None else (
            logits, tree_map(lambda d: d.vals[0], new))


def _shape(vals: list, spec: tuple, pos: Positions) -> torch.Size:
    """The whole shape of pieces laid out by ``spec``."""
    return torch.Size(n * pos.size(_axes(s))
                      for n, s in zip(vals[0].shape, spec))


def partitioned_step(step, in_shardings: Sequence,
                     out_shardings) -> PartitionedStep:
    """``step`` (of :func:`~repro_torch.train.serve.make_prefill`,
    :func:`~repro_torch.train.serve.make_serve_step` or
    :func:`~repro_torch.train.train_loop.make_train_step`) partitioned
    over the mesh of ``in_shardings``, as ``jax.jit(step,
    in_shardings=..., out_shardings=...)`` runs it under GSPMD: each
    position computes its share on its own shards, with the collectives
    of this module between.  ``in_shardings`` has one entry an argument
    of the step, in its order (trees for ``params``, ``caches``,
    ``opt_state`` and ``batch``); ``out_shardings`` is the logits'
    sharding (prefill), a ``(logits, caches)`` pair (decode) or a
    ``(params, opt_state, metrics)`` triple (train).

    Raises ``ValueError`` for any other function; it never falls back
    to gathering."""
    if getattr(step, "__code__", None) is _TRAIN:
        from .partition_train import PartitionedTrainStep
        return PartitionedTrainStep(step, in_shardings, out_shardings)
    return PartitionedStep(step, in_shardings, out_shardings)
