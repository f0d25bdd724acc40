"""SIMDRAM Step 3: the control unit that executes μPrograms.

Counterpart of :mod:`repro.core.control_unit`.  The paper places a small
control unit in the memory controller that replays a stored command
sequence whenever the CPU issues a ``bbop``: the same hardware executes
any μProgram, because programs are data.  :func:`encode_uprogram` turns a
μProgram into a dense ``(n_cmds, 13)`` int32 command table, and one
replay kernel (K5, ``csrc/replay.cu``) runs any table over any state, so
swapping the table never builds anything new.  K5 stops each unit at
its last real command: :func:`command_schedule` works out those counts,
and the order in which the kernel places the units, once per table
(:class:`CommandTables`, :data:`TABLE_CACHE`).

Command word layout (int32 × 13)::

  [ is_ap,  r0, n0,  r1, n1,  r2, n2,  w0, nw0,  w1, nw1,  w2, nw2 ]

  AAP src→dst :  is_ap=0, (r0,n0)=src port, writes w0..w2 = dst (repeated)
  AP  triple  :  is_ap=1, reads = writes = the triple's three ports

Port semantics match :class:`repro_torch.core.subarray.Subarray` exactly:
a ``neg`` port reads/writes the complement (dual-contact cell).

States on the device are int32 bit-views of the reference's uint32
words: ``(n_units, n_rows, n_words)``.  :func:`replay` launches K5 for
CUDA tensors and runs :func:`replay_plain` for CPU tensors; the entry
points (:func:`run_command_table`, :func:`make_interpreter`,
:func:`batched_interpreter`, :func:`hetero_batched_interpreter`) also
take numpy states as :func:`load_state` emits them and numpy tables as
:func:`encode_uprogram` emits them, and move them to their ``device``.
:func:`faulty_bank_replay` (K6, the second kernel of ``csrc/replay.cu``)
is the same replay with fault injection, and
:func:`faulty_batched_interpreter` its entry point.  The ladder's
replays (:func:`chip_replay`, :func:`channel_replay`, :func:`rank_replay`
and the faulty chip and channel ones) flatten a stacked round's unit
axes into one and make one K5 or K6 launch; :func:`split_tier_interpreter`
cuts a round into the slabs of a device mesh instead, one launch a slab
on its position's device and stream.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build
from ..kernels.ref import popcount_u32
from .bitplane import to_i32_bits
from .telemetry import active_tracer
from .uprogram import C1, TRIPLES, UProgram

CMD_WIDTH = 13
KERNEL_MAX_ROWS = 256     # K5 and K6 keep row numbers in 8 bits
KERNEL_MAX_UNITS = 65535  # K5 and K6 put the units on the grid's y axis


# ---------------------------------------------------------------------------
# state layout helpers (shared by the isa "interp" backend and the bank
# engine — one definition of operand loading / output readout)
# ---------------------------------------------------------------------------

def load_state(
    uprog: UProgram, operands: Sequence[np.ndarray], n_columns: int,
    n_rows: int | None = None, out: np.ndarray | None = None,
) -> np.ndarray:
    """(n_rows, n_words) uint32 subarray state: C1 pinned, operand *i*'s
    bits packed vertically into ``uprog.in_rows[i]``.

    An operand entry of ``None`` is skipped — the caller supplies those
    rows already vertical (the bank dispatcher's operand-forwarding path
    writes producer bit-planes straight into the consumer state).
    ``out`` fills an existing zeroed slab in place (the wave packer
    passes its stacked state array's slot) instead of allocating.
    """
    from .subarray import pack_bits

    if out is not None:
        state = out
    else:
        state = np.zeros(
            (n_rows or uprog.n_rows_total, n_columns // 32), dtype=np.uint32)
    state[C1] = np.uint32(0xFFFFFFFF)
    for op_idx, rows in enumerate(uprog.in_rows):
        if operands[op_idx] is None:
            continue
        planes = pack_bits(
            np.asarray(operands[op_idx]).astype(np.uint64), len(rows),
            n_columns)
        state[list(rows)] = planes
    return state


def output_plane_rows(out_bits: Sequence[int], uprog: UProgram):
    """Physical state rows holding each output, LSB-first: one row list
    per declared output width (the rows whose planes ARE the vertical
    result — what the dispatcher forwards without unpacking)."""
    rows, pos = [], 0
    for w in out_bits:
        rows.append([uprog.out_rows[pos + j][0] for j in range(w)])
        pos += w
    return rows


def read_outputs(
    out_bits: Sequence[int], uprog: UProgram, state: np.ndarray,
    lanes: int, signed: bool = False,
):
    """Extract the op's outputs from an executed state: one int64 array
    per declared output width (two's-complement narrowed if ``signed``)."""
    from .subarray import unpack_bits

    outs = []
    for w, rows in zip(out_bits, output_plane_rows(out_bits, uprog)):
        vals = unpack_bits(state[rows], lanes).astype(np.int64)
        if signed:
            vals = vals & ((1 << w) - 1)
            vals = np.where(vals >= (1 << (w - 1)), vals - (1 << w), vals)
        outs.append(vals)
    return outs


def encode_uprogram(uprog: UProgram) -> np.ndarray:
    """μProgram -> (n_cmds, 13) int32 command table."""
    rows = []
    for c in uprog.commands:
        if c.kind == "AAP":
            (rs, ns), (rd, nd) = c.src, c.dst
            rows.append([0, rs, ns, rs, ns, rs, ns, rd, nd, rd, nd, rd, nd])
        else:
            t = TRIPLES[c.triple]
            flat: list = [1]
            for r, n in t:
                flat += [r, int(n)]
            for r, n in t:
                flat += [r, int(n)]
            rows.append(flat)
    return np.asarray(rows, dtype=np.int32).reshape(-1, CMD_WIDTH)


# ---------------------------------------------------------------------------
# K5: the replay kernel and its plain version
# ---------------------------------------------------------------------------

def replay_plain(states: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: a loop over commands, vectorized over units
    and words.  ``states`` (n_units, n_rows, n_words) int32; ``tables``
    (n_units, n_cmds, 13), or (n_cmds, 13) shared by every unit."""
    st = states.clone()
    n_units = st.shape[0]
    if tables.dim() == 2:
        tables = tables.expand(n_units, *tables.shape)
    unit = torch.arange(n_units, device=st.device)
    # per command: rows r0 r1 r2 w0 w1 w2, and masks 0 / -1 (all ones)
    # for is_ap and the six port negations
    rows = tables[..., 1::2].to(torch.int64).unbind(dim=2)
    masks = (-tables[..., 0::2]).unbind(dim=2)
    for c in range(tables.shape[1]):
        r0, r1, r2, w0, w1, w2 = (r[:, c] for r in rows)
        ap, m0, m1, m2, mw0, mw1, mw2 = (m[:, c, None] for m in masks)
        v0 = st[unit, r0] ^ m0
        v1 = st[unit, r1] ^ m1
        v2 = st[unit, r2] ^ m2
        val = torch.where(ap != 0, (v0 & v1) | (v0 & v2) | (v1 & v2), v0)
        st[unit, w0] = val ^ mw0
        st[unit, w1] = val ^ mw1
        st[unit, w2] = val ^ mw2
    return st


class CommandTables(NamedTuple):
    """Stacked command tables with the schedule K5 and K6 replay them by
    (:func:`command_schedule`), worked out once where the tables are
    built or cached (:func:`tables_from_numpy`, :data:`TABLE_CACHE`), so
    that a schedule always travels with the tables it was made from.
    :func:`replay` and :func:`faulty_bank_replay` take one wherever they
    take a table tensor."""
    tables: torch.Tensor      # (n_units, n_cmds, 13) int32
    schedule: torch.Tensor    # (2, n_units) int32, on the same device


def command_schedule(tables, n_units: Optional[int] = None) -> torch.Tensor:
    """(2, n_units) int32 on the tables' device: row 0 is each unit's
    real command count (the index of its last non-NOP command + 1; the
    all-zero NOPs after it change nothing), row 1 the units in
    decreasing order of that count (ties by unit index), the order in
    which K5 and K6 place their blocks.  ``tables`` is (n_units, n_cmds,
    13), or (n_cmds, 13) shared by ``n_units`` units; a host array is
    worked out on the CPU.  Tensor ops only: on the card, no host sync."""
    if not isinstance(tables, torch.Tensor):
        tables = torch.from_numpy(np.ascontiguousarray(tables, np.int32))
    t = tables if tables.dim() == 3 else tables[None]
    n_cmds = t.shape[1]
    idx = torch.arange(1, n_cmds + 1, dtype=torch.int32, device=t.device)
    counts = (t.ne(0).any(dim=2).to(torch.int32) * idx).amax(dim=1) \
        if n_cmds else torch.zeros(t.shape[0], dtype=torch.int32,
                                   device=t.device)
    if tables.dim() == 2:
        counts = counts.expand(n_units).contiguous()
    order = torch.argsort(counts, descending=True, stable=True)
    return torch.stack([counts, order.to(torch.int32)])


def _split_tables(tables):
    """``(table tensor, schedule or None)`` of a tensor or a
    :class:`CommandTables`."""
    if isinstance(tables, CommandTables):
        return tables.tables, tables.schedule
    return tables, None


def _kernel_schedule(states: torch.Tensor, tables: torch.Tensor,
                     schedule: Optional[torch.Tensor]) -> torch.Tensor:
    """The schedule a K5 or K6 launch reads: the one carried by the
    tables, checked, or one worked out on the device."""
    n_units, n_rows, _ = states.shape
    if n_rows > KERNEL_MAX_ROWS:
        raise ValueError(f"the replay kernels take at most "
                         f"{KERNEL_MAX_ROWS} state rows, got {n_rows}")
    if n_units > KERNEL_MAX_UNITS:
        raise ValueError(f"the replay kernels take at most "
                         f"{KERNEL_MAX_UNITS} units in one launch, got "
                         f"{n_units}")
    if schedule is None:
        return command_schedule(tables, n_units)
    if (tuple(schedule.shape) != (2, n_units)
            or schedule.dtype != torch.int32
            or schedule.device != states.device):
        raise ValueError(f"schedule must be int32 of shape (2, {n_units}) "
                         f"on {states.device}, got {schedule.dtype} of "
                         f"shape {tuple(schedule.shape)} on "
                         f"{schedule.device}")
    return schedule.contiguous()


def _replay_kernel(states: torch.Tensor, tables: torch.Tensor,
                   schedule: torch.Tensor) -> torch.Tensor:
    n_units, n_rows, n_words = states.shape
    out = torch.empty_like(states)
    n_cmds = tables.shape[-2]
    stride = 0 if tables.dim() == 2 else n_cmds * CMD_WIDTH
    tr = active_tracer()
    timed = tr.launch_begin(states.device) if tr is not None else None
    build.launch("replay", "replay_launch", states.data_ptr(), out.data_ptr(),
                 tables.data_ptr(), stride, schedule.data_ptr(), n_units,
                 n_rows, n_words, n_cmds, device=states.device)
    if tr is not None:
        tr.launch_end(timed)
    build.LAUNCHES["replay"] += 1
    return out


def replay(states: torch.Tensor, tables) -> torch.Tensor:
    """Replay command tables over (n_units, n_rows, n_words) int32 states:
    the K5 kernel for CUDA tensors, :func:`replay_plain` for CPU tensors.
    ``tables`` is (n_units, n_cmds, 13) — one table per unit — or
    (n_cmds, 13) shared by every unit, or a :class:`CommandTables`, whose
    schedule the kernel then reads; for a bare tensor it works the
    schedule out on the device.  On the CPU a schedule lets the plain
    replay skip idle units and trailing NOPs, as K5 does.  Returns the
    executed states."""
    tables, schedule = _split_tables(tables)
    if states.dim() != 3 or tables.dim() not in (2, 3):
        raise ValueError(f"states must be 3-D and tables 2-D or 3-D, got "
                         f"{tuple(states.shape)} and {tuple(tables.shape)}")
    if tables.shape[-1] != CMD_WIDTH or (
            tables.dim() == 3 and tables.shape[0] != states.shape[0]):
        raise ValueError(f"tables {tuple(tables.shape)} do not fit states "
                         f"{tuple(states.shape)}")
    if states.dtype != torch.int32 or tables.dtype != torch.int32:
        raise ValueError("states and tables must be int32")
    if states.device != tables.device:
        raise ValueError(f"states on {states.device}, tables on "
                         f"{tables.device}")
    states, tables = states.contiguous(), tables.contiguous()
    if states.device.type == "cpu":
        if schedule is not None:
            return _replay_plain_scheduled(states, tables, schedule)
        return replay_plain(states, tables)
    if states.device.type != "cuda":
        raise ValueError(f"unsupported device {states.device}")
    if states.numel() == 0:
        return states.clone()
    return _replay_kernel(states, tables,
                          _kernel_schedule(states, tables, schedule))


def _replay_plain_scheduled(states: torch.Tensor, tables: torch.Tensor,
                            schedule: torch.Tensor) -> torch.Tensor:
    """:func:`replay_plain` over the units with a real command only, up
    to the longest real count — as K5 stops: every command after a
    unit's count is an all-zero NOP, and a unit with none keeps its
    state.  Bit for bit :func:`replay_plain` of the whole tables."""
    counts = schedule[0].to(torch.int64)
    live = torch.nonzero(counts > 0).flatten()
    out = states.clone()
    if live.numel() == 0:
        return out
    n = int(counts.max())
    t = tables[live, :n] if tables.dim() == 3 else tables[:n]
    out[live] = replay_plain(states[live], t)
    return out


def _check_table(table: np.ndarray, n_rows: int) -> None:
    """Reject a host table the replay could not execute faithfully."""
    if table.ndim < 2 or table.shape[-1] != CMD_WIDTH:
        raise ValueError(f"command tables are (n_cmds, {CMD_WIDTH}), got "
                         f"{table.shape}")
    rows = table[..., 1::2]
    flags = table[..., 0::2]
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError(f"table addresses rows outside [0, {n_rows})")
    if flags.size and (flags.min() < 0 or flags.max() > 1):
        raise ValueError("is_ap and port-negation flags must be 0 or 1")


def _state_tensor(state, device: torch.device) -> torch.Tensor:
    if isinstance(state, torch.Tensor):
        return state.to(device)
    arr = np.ascontiguousarray(state)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.astype(np.int32, copy=False)).to(device)


def _table_tensor(table, device: torch.device, n_rows: int):
    if isinstance(table, CommandTables):
        return CommandTables(table.tables.to(device),
                             table.schedule.to(device))
    if isinstance(table, torch.Tensor):
        return table.to(device)
    arr = np.ascontiguousarray(table, dtype=np.int32)
    _check_table(arr, n_rows)
    return torch.from_numpy(arr).to(device)


def tables_from_numpy(tables: Sequence[np.ndarray], device="cuda",
                      n_cmds: Optional[int] = None) -> CommandTables:
    """Stack host (n_cmds_i, 13) int32 tables — e.g. the reference
    package's ``encode_uprogram`` output — into one (n_units, n_cmds, 13)
    int32 tensor on ``device``, NOP-padding each to ``n_cmds`` (default:
    the longest), with its :func:`command_schedule`."""
    arrs = [np.asarray(t, dtype=np.int32).reshape(-1, CMD_WIDTH)
            for t in tables]
    width = max((a.shape[0] for a in arrs), default=0)
    n_cmds = width if n_cmds is None else n_cmds
    out = np.stack([pad_command_table(a, n_cmds) for a in arrs]) if arrs \
        else np.zeros((0, n_cmds, CMD_WIDTH), np.int32)
    flags = out[..., 0::2]
    if flags.size and (flags.min() < 0 or flags.max() > 1):
        raise ValueError("is_ap and port-negation flags must be 0 or 1")
    if out.size and out[..., 1::2].min() < 0:
        raise ValueError("negative row address in a command table")
    dev = build.resolve_device(device)
    host = torch.from_numpy(out)
    return CommandTables(host.to(dev), command_schedule(host).to(dev))


def run_command_table(state, table, device="cuda") -> torch.Tensor:
    """The control unit: replay one (n_cmds, 13) table over one
    (n_rows, n_words) state on ``device``; returns the executed state."""
    dev = build.resolve_device(device)
    st = _state_tensor(state, dev)
    tb = _table_tensor(table, dev, st.shape[0])
    return replay(st[None], tb)[0]


def make_interpreter(device="cuda"):
    """A replay function ``run(state, table)`` on ``device`` (the
    reference's non-donating jitted interpreter)."""
    def run(state, table):
        return run_command_table(state, table, device)

    return run


def batched_interpreter(device="cuda"):
    """``run(states, table)``: (n_subarrays, n_rows, n_words) states × one
    shared (n_cmds, 13) table — every subarray replays the same μProgram
    over its own rows, the paper's bank-level broadcast.  One K5 launch
    (:func:`replay` takes a shared table as it takes stacked ones)."""
    return hetero_batched_interpreter(device)


def hetero_batched_interpreter(device="cuda"):
    """``run(states, tables)``: (n_subarrays, n_rows, n_words) states ×
    (n_subarrays, n_cmds, 13) per-subarray tables, or their
    :class:`CommandTables` — one replay executes a different μProgram on
    every subarray (shorter programs NOP-padded to the wave's command
    bucket).  One K5 launch."""
    return _interpreter(replay, device)


def _interpreter(body, device):
    """``run(states, tables)``: ``body`` on ``device`` over host arrays
    (uint32 states, int32 tables) or tensors."""
    dev = build.resolve_device(device)

    def run(states, tables):
        st = _state_tensor(states, dev)
        return body(st, _table_tensor(tables, dev, st.shape[-2]))

    return run


# ---------------------------------------------------------------------------
# K6: fault-injected replay (repro_torch.core.fault)
# ---------------------------------------------------------------------------
#
# The same replay with the paper's section 5 failure modes: per-activation
# TRA bit flips (a Bernoulli(p) mask XORed into every AP result), stuck-at
# columns (``stuck1``/``stuck0`` word masks forced on every write and on
# the initial state) and dead subarrays (random garbage XORed over the
# whole unit after the last command).
#
# The reference draws its bits with ``jax.random``, which cannot be
# reproduced outside JAX.  Here every random word comes from a
# counter-based Philox4x32-10 keyed by the unit's (2,) uint32 key from
# ``FaultRuntime.draw_keys``; the counter is (word, command, stream,
# call), stream 0 for flips and 1 for dead-unit garbage.  A flip mask
# takes 8 calls per word per AP command: uniform 4 call + lane (32 bits
# of a call's output lane) sets bit 4 call + lane when it is below
# ``round(p 2^32)``.  Garbage word (row, word) is lane ``row & 3`` of the
# call with counter (word, row >> 2, 1, 0).  The plain version computes
# the same bits in torch, so kernel and plain version agree bit for bit;
# ``p = 0`` flips nothing and ``p = 1`` flips every bit, the two ends at
# which the reference is deterministic too.

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF
FLIP_CALLS = 8            # Philox calls per word per AP command
STREAM_FLIP, STREAM_DEAD = 0, 1


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for a constant ``m < 2^32`` and
    int64 ``x`` in [0, 2^32): the product needs 64 unsigned bits, so it
    is taken in 16-bit halves of ``x`` that keep every step below 2^49."""
    t = m * (x & 0xFFFF)
    u = m * (x >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _U32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 reference) on
    int64 tensors holding 32-bit values: ``counter`` is four broadcastable
    tensors (or ints), ``key`` two.  Returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _U32
            k1 = (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def flip_threshold(p_flip: float) -> int:
    """A 32-bit uniform below this sets a flip bit: ``round(p 2^32)``, so
    ``p = 0`` flips nothing and ``p = 1`` (2^32) every bit."""
    p = float(p_flip)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p_flip must be in [0, 1], got {p}")
    return min(1 << 32, int(round(p * (1 << 32))))


# Philox elements the plain version holds per chunk of commands
_PLAIN_PHILOX_CHUNK = 1 << 22


def flip_masks_plain(keys: torch.Tensor, cmds: torch.Tensor, n_words: int,
                     thr: int) -> torch.Tensor:
    """(n_units, len(cmds), n_words) int32 flip masks of the commands
    ``cmds`` (int64 indices), as if each were an AP command."""
    dev = keys.device
    shape = (keys.shape[0], cmds.shape[0], n_words)
    if thr == 0:
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    if thr >= 1 << 32:
        return torch.full(shape, -1, dtype=torch.int32, device=dev)
    k = keys.to(torch.int64) & _U32
    word = torch.arange(n_words, dtype=torch.int64, device=dev)
    call = torch.arange(FLIP_CALLS, dtype=torch.int64, device=dev)
    outs = philox4x32(
        (word[None, None, :, None], cmds.to(dev)[None, :, None, None],
         STREAM_FLIP, call[None, None, None, :]),
        (k[:, 0, None, None, None], k[:, 1, None, None, None]))
    bit = 4 * call[:, None] + torch.arange(4, device=dev)[None, :]  # (8, 4)
    u = torch.stack(outs, dim=-1)                       # (..., call, lane)
    mask = ((u < thr).to(torch.int64) << bit).sum(dim=(-2, -1))
    return to_i32_bits(mask)


def dead_garbage_plain(keys: torch.Tensor, n_rows: int,
                       n_words: int) -> torch.Tensor:
    """(n_units, n_rows, n_words) int32 garbage words of stream 1."""
    dev = keys.device
    k = keys.to(torch.int64) & _U32
    word = torch.arange(n_words, dtype=torch.int64, device=dev)
    quad = torch.arange((n_rows + 3) // 4, dtype=torch.int64, device=dev)
    outs = philox4x32(
        (word[None, None, :], quad[None, :, None], STREAM_DEAD, 0),
        (k[:, 0, None, None], k[:, 1, None, None]))
    g = torch.stack(outs, dim=2).reshape(k.shape[0], -1, n_words)[:, :n_rows]
    return to_i32_bits(g)


def _flip_stream(tables: torch.Tensor, keys: torch.Tensor, n_words: int,
                 thr: int, counts: torch.Tensor):
    """Yield ``(command, (n_units, n_words) flip masks)`` for every command
    that is an AP in some unit, in order, zero for units where it is not;
    adds each mask's flips to ``counts``.  Masks are drawn a chunk of
    commands at a time, vectorized over units, commands, words and
    calls."""
    if thr == 0:
        return
    is_ap = tables[..., 0] != 0                          # (n_units, n_cmds)
    ap_cmds = is_ap.any(dim=0).nonzero().flatten()
    chunk = max(1, _PLAIN_PHILOX_CHUNK // max(1, keys.shape[0] * n_words
                                              * FLIP_CALLS * 4))
    for lo in range(0, ap_cmds.shape[0], chunk):
        cmds = ap_cmds[lo: lo + chunk]
        masks = flip_masks_plain(keys, cmds, n_words, thr)
        masks = torch.where(is_ap[:, cmds, None], masks, 0)
        counts += popcount_u32(masks).sum(dim=(1, 2)).to(torch.int64)
        for j, c in enumerate(cmds.tolist()):
            yield c, masks[:, j]


def faulty_replay_plain(states, tables, keys, stuck0, stuck1, dead,
                        p_flip):
    """Plain version of K6: :func:`replay_plain` with the stuck masks on
    the initial state and every write, Philox flip masks XORed into every
    AP result, flips counted per unit over every word, and garbage XORed
    over dead units."""
    n_units, n_rows, n_words = states.shape
    if tables.dim() == 2:
        tables = tables.expand(n_units, *tables.shape)
    thr = flip_threshold(p_flip)
    s0, s1 = stuck0, stuck1
    st = (states | s1[:, None, :]) & ~s0[:, None, :]
    unit = torch.arange(n_units, device=st.device)
    rows = tables[..., 1::2].to(torch.int64).unbind(dim=2)
    masks = (-tables[..., 0::2]).unbind(dim=2)
    counts = torch.zeros(n_units, dtype=torch.int64, device=st.device)
    flips = _flip_stream(tables, keys, n_words, thr, counts)
    nxt = next(flips, None)
    for c in range(tables.shape[1]):
        r0, r1, r2, w0, w1, w2 = (r[:, c] for r in rows)
        ap, m0, m1, m2, mw0, mw1, mw2 = (m[:, c, None] for m in masks)
        v0 = st[unit, r0] ^ m0
        v1 = st[unit, r1] ^ m1
        v2 = st[unit, r2] ^ m2
        val = torch.where(ap != 0, (v0 & v1) | (v0 & v2) | (v1 & v2), v0)
        if nxt is not None and nxt[0] == c:
            val = val ^ nxt[1]
            nxt = next(flips, None)
        st[unit, w0] = ((val ^ mw0) | s1) & ~s0
        st[unit, w1] = ((val ^ mw1) | s1) & ~s0
        st[unit, w2] = ((val ^ mw2) | s1) & ~s0
    if bool(dead.any()):
        garbage = dead_garbage_plain(keys, n_rows, n_words)
        st = torch.where(dead[:, None, None], st ^ garbage, st)
    return st, counts


def _faulty_replay_kernel(states, tables, schedule, keys, stuck0, stuck1,
                          dead, thr):
    n_units, n_rows, n_words = states.shape
    out = torch.empty_like(states)
    counts = torch.zeros(n_units, dtype=torch.int64, device=states.device)
    n_cmds = tables.shape[-2]
    stride = 0 if tables.dim() == 2 else n_cmds * CMD_WIDTH
    tr = active_tracer()
    timed = tr.launch_begin(states.device) if tr is not None else None
    build.launch("replay", "faulty_replay_launch", states.data_ptr(),
                 out.data_ptr(), tables.data_ptr(), stride,
                 schedule.data_ptr(), keys.data_ptr(), stuck0.data_ptr(),
                 stuck1.data_ptr(), dead.data_ptr(), counts.data_ptr(), thr,
                 n_units, n_rows, n_words, n_cmds, device=states.device)
    if tr is not None:
        tr.launch_end(timed)
    build.LAUNCHES["faulty_replay"] += 1
    return out, counts


def faulty_bank_replay(states, tables, keys, stuck0, stuck1, dead, p_flip):
    """Fault-injected replay: the K6 kernel for CUDA tensors,
    :func:`faulty_replay_plain` for CPU tensors.

    Args:
        states: (n_units, n_rows, n_words) int32.
        tables: (n_units, n_cmds, 13) int32, or (n_cmds, 13) shared, or
            their :class:`CommandTables` (as :func:`replay` takes them).
        keys:   (n_units, 2) int32 — the bit-views of the per-unit uint32
            Philox keys.
        stuck0/stuck1: (n_units, n_words) int32 — stuck-at-0/1 column
            masks (bit set = that column is defective).
        dead:   (n_units,) bool — whole-unit failures.
        p_flip: per-activation per-bit flip probability.

    Returns:
        ``(out_states, flip_counts)`` — executed states with faults
        applied, and the injected AP bit flips per unit (int64).
    """
    tables, schedule = _split_tables(tables)
    if states.dim() != 3 or tables.dim() not in (2, 3):
        raise ValueError(f"states must be 3-D and tables 2-D or 3-D, got "
                         f"{tuple(states.shape)} and {tuple(tables.shape)}")
    n_units, _, n_words = states.shape
    if tables.shape[-1] != CMD_WIDTH or (
            tables.dim() == 3 and tables.shape[0] != n_units):
        raise ValueError(f"tables {tuple(tables.shape)} do not fit states "
                         f"{tuple(states.shape)}")
    expect = {"keys": (keys, (n_units, 2), torch.int32),
              "stuck0": (stuck0, (n_units, n_words), torch.int32),
              "stuck1": (stuck1, (n_units, n_words), torch.int32),
              "dead": (dead, (n_units,), torch.bool)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if states.dtype != torch.int32 or tables.dtype != torch.int32:
        raise ValueError("states and tables must be int32")
    tensors = [states, tables, keys, stuck0, stuck1, dead]
    if any(t.device != states.device for t in tensors):
        raise ValueError("all inputs must lie on one device")
    thr = flip_threshold(p_flip)
    states, tables, keys, stuck0, stuck1, dead = (
        t.contiguous() for t in tensors)
    if states.device.type == "cpu":
        return faulty_replay_plain(states, tables, keys, stuck0, stuck1,
                                   dead, p_flip)
    if states.device.type != "cuda":
        raise ValueError(f"unsupported device {states.device}")
    if states.numel() == 0:
        return (states.clone(),
                torch.zeros(n_units, dtype=torch.int64, device=states.device))
    return _faulty_replay_kernel(
        states, tables, _kernel_schedule(states, tables, schedule), keys,
        stuck0, stuck1, dead, thr)


def faulty_batched_interpreter(device="cuda"):
    """``run(states, tables, keys, stuck0, stuck1, dead, p)`` →
    ``(out_states, flip_counts)`` on ``device``: the bank tier's faulty
    wave executor, one K6 launch.  Takes host arrays as the reference's
    ``faulty_execute`` builds them (uint32 states, keys and masks, bool
    dead) or tensors (tables also as :class:`CommandTables`), and
    returns device tensors."""
    return _faulty_interpreter(faulty_bank_replay, device)


def _faulty_interpreter(body, device):
    """``run(states, tables, keys, stuck0, stuck1, dead, p)``: the
    fault-injected ``body`` on ``device`` over host arrays or tensors."""
    dev = build.resolve_device(device)

    def run(states, tables, keys, stuck0, stuck1, dead, p_flip):
        st = _state_tensor(states, dev)
        return body(st, _table_tensor(tables, dev, st.shape[-2]),
                    _state_tensor(keys, dev), _state_tensor(stuck0, dev),
                    _state_tensor(stuck1, dev), _bool_tensor(dead, dev),
                    p_flip)

    return run


def _bool_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.bool)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=bool)).to(device)


# ---------------------------------------------------------------------------
# the ladder's replays: chip, channel and rank rounds
# ---------------------------------------------------------------------------
#
# The reference vmaps the bank replay over banks (chip), chips (channel)
# and channels (rank).  Units share nothing and K6 keys its Philox
# counter per unit, so here the leading unit axes of states, tables,
# keys, stuck masks and ``dead`` flatten into one unit axis: a round is
# one K5 launch (or one K6 launch), reshaped back, bit for bit what the
# reference's vmap computes.  ``n_lead`` counts the unit axes: 2 for a
# chip round (banks, subarrays), 3 for a channel super-round, 4 for a
# rank round.  Tables come as (*units, n_cmds, 13) tensors, or as a
# :class:`CommandTables` already flattened to (n_units, n_cmds, 13) with
# the schedule of every unit of the round.

def _flat_tables(tables, lead: tuple, n_units: int):
    """Tables of a stacked round, flattened to one unit axis."""
    if isinstance(tables, CommandTables):
        t = tables.tables
        if t.dim() != 3 or t.shape[0] != n_units:
            raise ValueError(f"round tables {tuple(t.shape)} do not cover "
                             f"the {n_units} units of a {lead} round")
        return tables
    if tuple(tables.shape[:-2]) != lead:
        raise ValueError(f"tables {tuple(tables.shape)} do not fit the unit "
                         f"axes {lead} of the states")
    return tables.reshape(n_units, *tables.shape[-2:])


def _unit_axes(states: torch.Tensor, n_lead: int):
    """``(unit axes, states with them flattened into one)``."""
    if states.dim() != n_lead + 2:
        raise ValueError(f"states must have {n_lead} unit axes and (n_rows, "
                         f"n_words), got {tuple(states.shape)}")
    return (tuple(states.shape[:n_lead]),
            states.reshape(-1, *states.shape[n_lead:]))


def _tier_replay(states: torch.Tensor, tables, n_lead: int) -> torch.Tensor:
    lead, flat = _unit_axes(states, n_lead)
    out = replay(flat, _flat_tables(tables, lead, flat.shape[0]))
    return out.reshape(states.shape)


def _check_fault_axes(lead: tuple, keys, stuck0, stuck1, dead) -> None:
    """The fault operands of a round carry the states' unit axes."""
    for name, t, tail in (("keys", keys, 1), ("stuck0", stuck0, 1),
                          ("stuck1", stuck1, 1), ("dead", dead, 0)):
        if tuple(t.shape[:len(t.shape) - tail]) != lead:
            raise ValueError(f"{name} {tuple(t.shape)} do not fit the unit "
                             f"axes {lead} of the states")


def _faulty_tier_replay(states, tables, keys, stuck0, stuck1, dead, p_flip,
                        n_lead: int):
    lead, flat = _unit_axes(states, n_lead)
    n_units = flat.shape[0]
    _check_fault_axes(lead, keys, stuck0, stuck1, dead)
    out, counts = faulty_bank_replay(
        flat, _flat_tables(tables, lead, n_units),
        keys.reshape(n_units, 2), stuck0.reshape(n_units, -1),
        stuck1.reshape(n_units, -1), dead.reshape(n_units), p_flip)
    return out.reshape(states.shape), counts.reshape(lead)


def tier_interpreter(n_lead: int, device="cuda", fault: bool = False):
    """The executor body of a tier whose stacked rounds have ``n_lead``
    unit axes, on ``device``, over host arrays (as the tiers pack them
    and ``faulty_execute`` builds them) or tensors; returns device
    tensors.  ``run(states, tables)`` is one K5 launch; with ``fault``,
    ``run(states, tables, keys, stuck0, stuck1, dead, p)`` →
    ``(out_states, flip_counts)`` is one K6 launch."""
    if fault:
        return _faulty_interpreter(
            functools.partial(_faulty_tier_replay, n_lead=n_lead), device)
    return _interpreter(functools.partial(_tier_replay, n_lead=n_lead),
                        device)


# the reference's names: the replays take a round's states with their
# unit axes, (n_banks, n_subarrays) on a chip, (n_chips, ...) on a
# channel, (n_channels, n_chips, ...) on a rank, and the interpreters
# take a device
chip_replay = functools.partial(_tier_replay, n_lead=2)
channel_replay = functools.partial(_tier_replay, n_lead=3)
rank_replay = functools.partial(_tier_replay, n_lead=4)
faulty_chip_replay = functools.partial(_faulty_tier_replay, n_lead=2)
faulty_channel_replay = functools.partial(_faulty_tier_replay, n_lead=3)
chip_batched_interpreter = functools.partial(tier_interpreter, 2)
channel_batched_interpreter = functools.partial(tier_interpreter, 3)
rank_batched_interpreter = functools.partial(tier_interpreter, 4)
faulty_chip_batched_interpreter = functools.partial(tier_interpreter, 2,
                                                    fault=True)
faulty_channel_batched_interpreter = functools.partial(tier_interpreter, 3,
                                                       fault=True)


# ---------------------------------------------------------------------------
# the ladder split across devices: one launch a slab
# ---------------------------------------------------------------------------
#
# The reference's shard_map cuts a round's leading unit axes into equal
# slabs, one a mesh position ("data" over banks; "channel" and "data" over
# chips and banks; "rank", "channel" and "data" over channels, chips and
# banks), and replays each with the same vmapped interpreter.  Here a
# split round cuts states and tables (on the fault path keys, stuck masks
# and dead flags too) into the same slabs.  Each slab gets its own
# CommandTables, because a schedule orders the units of one launch; it
# uploads to its position's device and makes one K5 (K6) launch there, on
# its position's stream, so that positions naming one device run side by
# side.  Slabs share nothing and K6 keys its Philox counter by each unit's
# own key, so a split round equals the unsplit one bit for bit.

class Slab(NamedTuple):
    """One mesh position's share of a round: (start, stop) on each split
    unit axis, the position's device and its stream (None on the CPU)."""
    bounds: Tuple[Tuple[int, int], ...]
    device: torch.device
    stream: Optional[object]

    @property
    def index(self) -> tuple:
        return tuple(slice(a, b) for a, b in self.bounds)


def _position_stream(streams: dict, device: torch.device, k: int):
    """The ``k``-th side stream of a CUDA device, made once into
    ``streams``; None for the CPU."""
    if device.type != "cuda":
        return None
    s = streams.get((device.index, k))
    if s is None:
        s = streams[(device.index, k)] = torch.cuda.Stream(device=device)
    return s


def mesh_slabs(mesh, axes: Sequence[str], lead: Sequence[int],
               streams: dict) -> List[Slab]:
    """The slabs of a round whose first unit axes ``lead`` split over the
    mesh axes ``axes`` (unit axis ``j`` into ``mesh.shape[axes[j]]``
    equal parts), in row-major order of the parts.  A slab runs on the
    device at its position (the mesh's other axes at 0); the ``k``-th
    slab on a device gets that device's ``k``-th stream, kept in
    ``streams`` (one dict an executor)."""
    parts = [mesh.shape[a] for a in axes]
    for a, n, m in zip(axes, lead, parts):
        if n % m:
            raise ValueError(f"a unit axis of {n} does not divide over mesh "
                             f"axis {a!r} of {m}")
    stride, acc = {}, 1
    for name in reversed(mesh.axis_names):
        stride[name] = acc
        acc *= mesh.shape[name]
    step = [n // m for n, m in zip(lead, parts)]
    seen: Dict[torch.device, int] = {}
    slabs = []
    for pos in itertools.product(*(range(m) for m in parts)):
        dev = torch.device(
            mesh.devices[sum(stride[a] * i for a, i in zip(axes, pos))])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        k = seen[dev] = seen.get(dev, -1) + 1
        slabs.append(Slab(tuple((i * s, (i + 1) * s)
                                for i, s in zip(pos, step)),
                          dev, _position_stream(streams, dev, k)))
    return slabs


@contextlib.contextmanager
def _on(slab: Slab, wait: bool = True):
    """``slab``'s device and stream made current; with ``wait`` the
    stream first waits for what the device's current stream has queued
    (the tables and states the slab reads)."""
    if slab.stream is None:
        yield
        return
    with torch.cuda.device(slab.device):
        if wait:
            slab.stream.wait_stream(torch.cuda.current_stream(slab.device))
        with torch.cuda.stream(slab.stream):
            yield


def _cut_tables(tables, lead: tuple, slabs: List[Slab]) -> List[CommandTables]:
    """Each slab's tables, flattened to one unit axis, with its schedule,
    on its device.  A :class:`CommandTables` of the round (flattened, as
    the tiers cache it) gives each slab its units' real counts, in the
    order of those counts; bare (*lead, n_cmds, 13) tables are worked
    out anew."""
    if isinstance(tables, CommandTables):
        t = _flat_tables(tables, lead, int(np.prod(lead))).tables
        counts = tables.schedule[0].reshape(lead)
    elif tuple(tables.shape[:-2]) == lead:
        t, counts = tables, None
    else:
        raise ValueError(f"tables {tuple(tables.shape)} do not fit the unit "
                         f"axes {lead} of the states")
    t = t.reshape(*lead, *t.shape[-2:])
    out = []
    for slab in slabs:
        ts = t[slab.index].reshape(-1, *t.shape[-2:])
        if counts is None:
            sched = command_schedule(ts)
        else:
            c = counts[slab.index].reshape(-1)
            sched = torch.stack([c, torch.argsort(
                c, descending=True, stable=True).to(torch.int32)])
        out.append(CommandTables(ts.to(slab.device), sched.to(slab.device)))
    return out


def _slab_tables(tables, lead: tuple, slabs: List[Slab]):
    """:func:`_cut_tables`, kept with the round's tables while the table
    cache holds them (a repeated round cuts nothing)."""
    if isinstance(tables, CommandTables):
        return TABLE_CACHE.slab_tables(
            tables, (lead, tuple((s.bounds, str(s.device)) for s in slabs)),
            lambda: _cut_tables(tables, lead, slabs))
    return _cut_tables(tables, lead, slabs)


def _cut(x, slab: Slab, device: torch.device, n_lead: int,
         dtype=None) -> torch.Tensor:
    """``x``'s share of ``slab`` (a host array or a tensor) on ``device``,
    its unit axes flattened into one."""
    part = x[slab.index]
    t = (_bool_tensor(part, device) if dtype is torch.bool
         else _state_tensor(part, device))
    return t.reshape(-1, *t.shape[n_lead:])


def _keep(ct: CommandTables, slab: Slab) -> None:
    """Tables made on another stream, read on the slab's: the caching
    allocator must not hand their memory out before that read ends."""
    if slab.stream is not None:
        ct.tables.record_stream(slab.stream)
        ct.schedule.record_stream(slab.stream)


def _copy_back(slabs: List[Slab], outs: list):
    """Queue each slab's outputs (a tuple of tensors a slab) to host
    memory on the slab's stream: (host tuples, the copies' events, or
    None where every slab is on the CPU)."""
    hosts, events = [], []
    for slab, tensors in zip(slabs, outs):
        if slab.stream is None:
            hosts.append(tensors)
            continue
        with _on(slab, wait=False):
            hosts.append(tuple(t.to("cpu", non_blocking=True)
                               for t in tensors))
            done = torch.cuda.Event()
            done.record(slab.stream)
            events.append(done)
    return hosts, (events or None)


def _assemble(shape: tuple, slabs: List[Slab], parts: list,
              dtype) -> torch.Tensor:
    """One host tensor of ``shape`` from each slab's part, in the unit
    order."""
    full = torch.empty(shape, dtype=dtype)
    for slab, part in zip(slabs, parts):
        dst = full[slab.index]
        dst.copy_(part.reshape(dst.shape))
    return full


class SlabRound(NamedTuple):
    """A split round's executed slabs, in slab order: each on its
    position's device, or in host memory after :meth:`to_host`."""
    shape: tuple
    slabs: List[Slab]
    outs: list                # (states,) a slab

    def to_host(self):
        """Queue every slab's copy to host memory on its own stream:
        (the round in host memory, the copies' events or None)."""
        hosts, events = _copy_back(self.slabs, self.outs)
        return self._replace(outs=hosts), events

    def assemble(self) -> torch.Tensor:
        """The round's (*units, n_rows, n_words) int32 host states, in
        the unit order (after the copies have ended)."""
        return _assemble(self.shape, self.slabs,
                         [o[0] for o in self.outs], torch.int32)


def _split_round(states, tables, n_lead: int, mesh, axes, home, streams,
                 fault=None):
    """Every slab of a round through its launch on its position's device
    and stream: (the slabs, each slab's outputs).  ``fault`` is ``(keys,
    stuck0, stuck1, dead, p_flip)`` for K6, None for K5."""
    if len(states.shape) != n_lead + 2:
        raise ValueError(f"states must have {n_lead} unit axes and (n_rows, "
                         f"n_words), got {tuple(states.shape)}")
    lead = tuple(states.shape[:n_lead])
    if fault is not None:
        _check_fault_axes(lead, *fault[:4])
    slabs = mesh_slabs(mesh, axes, lead, streams)
    cts = _slab_tables(_table_tensor(tables, home, states.shape[-2]), lead,
                       slabs)
    tr = active_tracer()
    outs = []
    with tr.launch_group() if tr is not None else contextlib.nullcontext():
        for slab, ct in zip(slabs, cts):
            with _on(slab):
                _keep(ct, slab)
                st = _cut(states, slab, slab.device, n_lead)
                if fault is None:
                    outs.append((replay(st, ct),))
                    continue
                keys, stuck0, stuck1, dead, p_flip = fault
                outs.append(faulty_bank_replay(
                    st, ct, _cut(keys, slab, slab.device, n_lead),
                    _cut(stuck0, slab, slab.device, n_lead),
                    _cut(stuck1, slab, slab.device, n_lead),
                    _cut(dead, slab, slab.device, n_lead, torch.bool),
                    p_flip))
    return slabs, outs


def split_tier_interpreter(n_lead: int, mesh, axes: Sequence[str],
                           device="cuda", fault: bool = False):
    """The executor body of a tier whose rounds (``n_lead`` unit axes)
    split over ``mesh``: the first ``len(axes)`` unit axes cut over the
    mesh axes ``axes``, one K5 launch a slab on its position's device and
    stream.  ``run(states, tables)`` returns a :class:`SlabRound`
    (:func:`repro_torch.core.bank.submit_stacked` copies it back slab by
    slab); with ``fault``, ``run(states, tables, keys, stuck0, stuck1,
    dead, p)`` makes one K6 launch a slab and returns ``(states, flip
    counts)`` in host memory, in the unit order.  ``device`` is the
    home of the round's tables (the tier's device); inputs come as
    :func:`tier_interpreter` takes them."""
    home = build.resolve_device(device)
    axes = tuple(axes)
    streams: dict = {}
    if fault:
        def run(states, tables, keys, stuck0, stuck1, dead, p_flip):
            slabs, outs = _split_round(
                states, tables, n_lead, mesh, axes, home, streams,
                (keys, stuck0, stuck1, dead, p_flip))
            hosts, events = _copy_back(slabs, outs)
            for done in events or ():
                done.synchronize()
            return (_assemble(tuple(states.shape), slabs,
                              [h[0] for h in hosts], torch.int32),
                    _assemble(tuple(states.shape[:n_lead]), slabs,
                              [h[1] for h in hosts], torch.int64))
    else:
        def run(states, tables):
            return SlabRound(tuple(states.shape), *_split_round(
                states, tables, n_lead, mesh, axes, home, streams))
    return run


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """Kernel builds (``nvcc`` runs in this process, per library) and
    launches (per kernel) so far — the port's counterpart of the
    reference's ``trace_counts()``: a repeated dispatch builds nothing
    new, because tables and circuits are data."""
    return {"builds": dict(build.BUILDS), "launches": dict(build.LAUNCHES)}


# ---------------------------------------------------------------------------
# bank-level batched execution: NOP padding and shape buckets
# ---------------------------------------------------------------------------
#
# A command row of all zeros decodes to AAP(T0 -> T0): read row 0 through
# its d-port and write the same value back — a true NOP.  Padding every
# encoded table to a bucketed command count lets μPrograms of different
# lengths stack into one (n_units, n_cmds, 13) table array.

def pad_command_table(table: np.ndarray, n_cmds: int) -> np.ndarray:
    """Pad an encoded table with NOP rows up to ``n_cmds`` commands."""
    if table.shape[0] > n_cmds:
        raise ValueError(f"table has {table.shape[0]} cmds > bucket {n_cmds}")
    out = np.zeros((n_cmds, CMD_WIDTH), dtype=np.int32)
    out[: table.shape[0]] = table
    return out


def shape_bucket(x: int, base: int) -> int:
    """Harmonized array-dimension bucket: next power of two ≥ ``base``
    (and ≥ x).  Rounding wave dimensions (rows, columns) to shared
    buckets keeps the set of distinct replay shapes O(log max-dim)."""
    b = base
    while b < x:
        b *= 2
    return b


def table_bucket(n_cmds: int, min_bucket: int = 16) -> int:
    """Slot size for a μProgram of ``n_cmds`` commands: next power of two
    ≥ ``min_bucket``."""
    return shape_bucket(n_cmds, min_bucket)


# ---------------------------------------------------------------------------
# compile-once replay tables: device-resident command-table cache
# ---------------------------------------------------------------------------

class TableCache:
    """Memoizes encoded+padded+stacked command tables as device tensors,
    with their :func:`command_schedule`, keyed by the wave's composition
    — (op, width, style) per slot plus the shared command bucket (and the
    device).  A dispatch that replays
    a composition seen before pays zero host-side table work: no
    re-encode, no NOP re-pad, no host→device copy (the paper's μProgram
    memory: programs are written once and replayed forever).  Like that
    memory it has finite capacity: a device-byte budget, with the least
    recently replayed compositions evicted past it.

    A round split across a device mesh cuts each entry it replays into
    the slabs' own tables (:meth:`slab_tables`); the cuts are kept with
    the entry and leave with it, outside the byte budget (on one device
    a slab of whole leading units is a view of the entry's tensor).
    """

    def __init__(self, max_bytes: int = 128 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._store: "OrderedDict" = OrderedDict()
        # id of a cached entry's table tensor -> (that tensor, {slab
        # layout: per-slab CommandTables})
        self._slabs: Dict[int, tuple] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, build_table, device) -> CommandTables:
        """Return the cached device tables for ``key``, building them with
        ``build_table()`` (a host int32 array), working out their schedule
        and copying both to ``device`` on first use.  With a tracer, a
        ``table_cache.hit`` or ``table_cache.miss`` event (the host
        table's bytes) as in the reference."""
        tr = active_tracer()
        t = self._store.get(key)
        if t is None:
            self.misses += 1
            t0 = time.perf_counter() if tr is not None else 0.0
            host = torch.from_numpy(
                np.ascontiguousarray(build_table(), dtype=np.int32))
            t = self._store[key] = CommandTables(
                host.to(device), command_schedule(host).to(device))
            if tr is not None:
                tr.event("table_cache.miss", cat="cache", tier=key[0],
                         wall_s=time.perf_counter() - t0,
                         bytes=int(host.numel()) * 4)
            self._slabs[id(t.tables)] = (t.tables, {})
            self.bytes += _nbytes(t)
            while self.bytes > self.max_bytes and len(self._store) > 1:
                _, old = self._store.popitem(last=False)
                self._slabs.pop(id(old.tables), None)
                self.bytes -= _nbytes(old)
                self.evictions += 1
        else:
            self.hits += 1
            self._store.move_to_end(key)
            if tr is not None:
                tr.event("table_cache.hit", cat="cache", tier=key[0])
        return t

    def slab_tables(self, entry: CommandTables, layout, cut):
        """The per-slab tables of ``entry`` for a slab ``layout``: made
        by ``cut()`` once while ``entry`` is cached, and anew each call
        for tables the cache does not hold."""
        memo = self._slabs.get(id(entry.tables))
        if memo is None or memo[0] is not entry.tables:
            return cut()
        got = memo[1].get(layout)
        if got is None:
            got = memo[1][layout] = cut()
        return got

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._store), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def clear(self) -> None:
        self._store.clear()
        self._slabs.clear()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0


def _nbytes(entry: CommandTables) -> int:
    return sum(int(t.numel() * t.element_size()) for t in entry)


TABLE_CACHE = TableCache()
