"""K3: fused execution of a SIMDRAM circuit on bit-planes.

Counterpart of :mod:`repro.kernels.bitplane_ops` (``circuit_on_planes``,
a Pallas body generated per circuit).  Here one generic CUDA kernel
(``csrc/circuit.cu``) runs every circuit: :func:`lower_circuit` turns a
synthesized :class:`~repro_torch.core.logic.Circuit` into a level-parallel
slot program, and the kernel deals each level's gates across the warps
of a block that shares one tile of words and its slot file in shared
memory.

:func:`circuit_on_planes` is the single circuit path of the port: the
bit-plane backend, ``bbop_cuda`` and the bank's ``bitplane`` and
``cuda`` engines all call it.  It launches the kernel for CUDA tensors
and runs :func:`circuit_plain` (``Circuit.evaluate_outputs`` on int32
tensors) for CPU tensors.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.logic import Circuit
from . import build

# Constants shared with csrc/circuit.cu
TILE_WORDS = 64           # words of a block's tile: two per lane (kTileWords)
SLOT_BYTES = 4 * TILE_WORDS
LOOKAHEAD = 8             # steps from a load's issue to its use (kAhead)
GATE_INTS = 4             # int32 per gate entry
CHUNK_GATES = 1024        # most gate entries staged in shared memory at once
MAX_SHARED_BYTES = 232448
MAX_OPERANDS = 4          # and_red, or_red and xor_red take four
GATES_PER_WARP = 3        # mean gates a warp takes per level
MIN_WARPS, MAX_WARPS = 2, 4   # measured best on an H100 (PERF.md)
_ZERO = -1                # the all-zeros slot 0 (constants, AND/OR/XOR)


@dataclass(frozen=True)
class SlotProgram:
    """A circuit lowered for the K3 kernel: a list of steps, each one
    level of the circuit (or a part of one), run by all warps of a block
    between two barriers.

    ``gates`` (n_gates, 4) int32, one branch-free entry per gate: the
    byte offsets in the slot file of its arguments a, b, c and of its
    result; bit 0 of a's offset marks XOR, bit 0 of c's a complemented c.
    The result is MAJ(a, b, c or ~c), or a ^ b ^ c.  A slot may hold a
    node's complement: the lowering tracks which do and folds that into
    the readers (MAJ is self-dual, so at most one argument of a MAJ stays
    complemented, and it is put last) and the stores' masks.
    ``loads`` (n_loads, 3): operand, plane, slot byte offset.
    ``stores`` (n_stores, 3): output plane, slot byte offset, mask.
    ``steps`` (n_steps + 1, 3): the first gate, load and store of each
    step.  ``chunks`` (n_chunks + 1,): the first step of each run of
    steps whose gates are staged in shared memory together.
    ``code`` is all five flattened, in that order, for the kernel; it
    stages the tables in shared memory once per block, and the gates
    chunk by chunk."""

    gates: np.ndarray
    loads: np.ndarray
    stores: np.ndarray
    steps: np.ndarray
    chunks: np.ndarray
    n_slots: int
    n_inputs: int
    n_outputs: int
    n_levels: int
    warps: int        # warps per block, from the mean level width
    has_xor: bool
    chunk_cap: int    # most gates of one chunk: the staged entries

    @property
    def n_gates(self) -> int:
        return int(self.gates.shape[0])

    @property
    def n_logic(self) -> int:
        """Bitwise operations per word: one LOP3 per gate (a complement
        folds into the LUT)."""
        return self.n_gates

    @property
    def n_steps(self) -> int:
        return int(self.steps.shape[0]) - 1

    @property
    def table_ints(self) -> int:
        """int32 of steps, loads, stores and chunks, padded to 16 bytes
        (the kernel stages them in shared memory with 16-byte copies)."""
        n = (self.steps.size + self.loads.size + self.stores.size
             + self.chunks.size)
        return -(-n // 4) * 4

    @property
    def code(self) -> np.ndarray:
        tables = np.concatenate([self.steps.ravel(), self.loads.ravel(),
                                 self.stores.ravel(), self.chunks])
        pad = np.zeros(self.table_ints - tables.size, np.int32)
        return np.concatenate([self.gates.ravel(), tables,
                               pad]).astype(np.int32)

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one block: the staged gates, the
        tables and the slot file."""
        return (self.chunk_cap * GATE_INTS * 4 + self.table_ints * 4
                + self.n_slots * SLOT_BYTES)


def _schedule(gates: List[Tuple[int, List[Tuple[int, int]], bool]],
              in_pos: Dict[int, Tuple[int, int]],
              n_levels: int) -> Dict[int, int]:
    """Each gate's level, keeping the circuit's depth: a gate runs at the
    latest level its readers allow, or earlier where it takes no more
    slots than it gives back (it is the last reader of as many values as
    it creates: its result, unless only stored, and inputs not yet
    loaded).  Gates are in topological order."""
    readers: Dict[int, List[int]] = {}
    for i, (_, srcs, _) in enumerate(gates):
        for b in {b for b, _ in srcs}:
            readers.setdefault(b, []).append(i)
    gate_of = {nid: i for i, (nid, _, _) in enumerate(gates)}
    late = [n_levels] * len(gates)
    for i in reversed(range(len(gates))):
        for r in readers.get(gates[i][0], ()):
            late[i] = min(late[i], late[r] - 1)
    left = {b: len(rs) for b, rs in readers.items()}      # readers to run
    waiting = [sum(b in gate_of for b in {b for b, _ in srcs})
               for _, srcs, _ in gates]
    ready = {i for i, n in enumerate(waiting) if n == 0}
    loaded = set()
    level: Dict[int, int] = {}

    def take(i: int) -> None:
        for b in {b for b, _ in gates[i][1]}:
            left[b] -= 1
            if b in in_pos:
                loaded.add(b)

    for lv in range(1, n_levels + 1):
        now = sorted(i for i in ready if late[i] == lv)
        for i in now:
            take(i)
        rest = sorted(ready.difference(now))
        grew = True
        while grew:
            grew = False
            for i in rest:
                if i in now:
                    continue
                args = {b for b, _ in gates[i][1]} - {_ZERO}
                cost = (int(gates[i][0] in readers)
                        + sum(b in in_pos and b not in loaded for b in args)
                        - sum(left[b] == 1 for b in args))
                if cost <= 0:
                    take(i)
                    now.append(i)
                    grew = True
        ready.difference_update(now)
        for i in now:
            level[gates[i][0]] = lv
            for r in readers.get(gates[i][0], ()):
                waiting[r] -= 1
                if waiting[r] == 0:
                    ready.add(r)
    return level


def lower_circuit(circ: Circuit,
                  input_ids: Sequence[Sequence[int]]) -> SlotProgram:
    """Lower ``circ`` to a level-parallel slot program: the one of
    :func:`_candidates` with the fewer slots."""
    prog = min(_candidates(circ, input_ids), key=lambda p: p.n_slots)
    if prog.shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"circuit needs {prog.n_slots} slots: "
                         f"{prog.shared_bytes} bytes of shared memory, "
                         f"more than {MAX_SHARED_BYTES}")
    return prog


def _candidates(circ: Circuit, input_ids: Sequence[Sequence[int]]
                ) -> List[SlotProgram]:
    """The slot programs of ``circ`` with its gates as soon as possible
    and as :func:`_schedule` places them.  The second takes fewer slots
    on most circuits the repo compiles; the first on ``abs`` at every
    width (experiments/circuit_lowering.py).

    NOT folds into the complement masks of its readers, constants into
    the zero slot, AND/OR/XOR into MAJ or XOR with the zero slot.  Each
    gate gets a level above its arguments' within the circuit's depth;
    the gates of one level form a step (split at ``CHUNK_GATES``), after
    ``LOOKAHEAD`` steps that only load.  An input plane is loaded
    ``LOOKAHEAD`` steps before its first use, an output stored the step
    after its node is computed.  A slot is taken at the step its node is
    written (or its load issued) and returns to the pool after the last
    step that reads it, so no step reads a slot that the same step
    writes; the lowest free slot is taken first."""
    if len(input_ids) > MAX_OPERANDS:
        raise ValueError(f"at most {MAX_OPERANDS} operands, got "
                         f"{len(input_ids)}")
    in_pos: Dict[int, Tuple[int, int]] = {}
    for k, ids in enumerate(input_ids):
        for j, nid in enumerate(ids):
            in_pos[nid] = (k, j)
    ref: Dict[int, Tuple[int, int]] = {}    # node -> (base node, complement)
    level: Dict[int, int] = {_ZERO: 0}
    gates: List[Tuple[int, List[Tuple[int, int]], bool]] = []
    for nid in circ.live_nodes():
        op, args = circ.ops[nid], circ.args[nid]
        if op == "in":
            if nid not in in_pos:
                raise ValueError(f"input node {nid} is not in input_ids")
            ref[nid], level[nid] = (nid, 0), 0
        elif op in ("c0", "c1"):
            ref[nid] = (_ZERO, int(op == "c1"))
        elif op == "not":
            base, comp = ref[args[0]]
            ref[nid] = (base, comp ^ 1)
        elif op in ("maj", "and", "or", "xor"):
            srcs = [ref[a] for a in args]
            if op != "maj":
                srcs.append((_ZERO, int(op == "or")))
            ref[nid] = (nid, 0)
            level[nid] = 1 + max(level[b] for b, _ in srcs)
            gates.append((nid, srcs, op == "xor"))
        else:
            raise ValueError(f"unknown gate {op!r}")
    n_levels = max((level[g[0]] for g in gates), default=0)
    outputs = [ref[nid] for nid in circ.outputs]
    return [_emit(gates, outputs, in_pos, lv, n_levels)
            for lv in (level, _schedule(gates, in_pos, n_levels))]


def _emit(gates: List[Tuple[int, List[Tuple[int, int]], bool]],
          outputs: List[Tuple[int, int]],
          in_pos: Dict[int, Tuple[int, int]], level: Dict[int, int],
          n_levels: int) -> SlotProgram:
    """The slot program of ``gates`` run at ``level``; ``outputs`` are
    (base node, complement) per output plane."""
    # steps: LOOKAHEAD load-only steps, then the levels in order
    by_level: List[List[int]] = [[] for _ in range(n_levels + 1)]
    for i, g in enumerate(gates):
        by_level[level[g[0]]].append(i)
    step_gates: List[List[int]] = [[] for _ in range(LOOKAHEAD)]
    for lv in by_level[1:]:
        for k in range(0, len(lv), CHUNK_GATES):
            step_gates.append(lv[k:k + CHUNK_GATES])
    born: Dict[int, int] = {}
    last_read: Dict[int, int] = {}
    for s, idx in enumerate(step_gates):
        for i in idx:
            nid, srcs, _ = gates[i]
            born[nid] = s
            for b, _ in srcs:
                if b in in_pos and b not in born:   # load ahead of use
                    born[b] = s - LOOKAHEAD
                last_read[b] = s
    store_at: List[Tuple[int, int, int]] = []   # (step, position, base)
    for pos, (base, _) in enumerate(outputs):
        if base in in_pos and base not in born:
            born[base] = 0        # an input that is only stored
        if base == _ZERO:
            s = None              # stored at the last step
        elif base in in_pos:
            s = born[base] + LOOKAHEAD
        else:
            s = born[base] + 1
        store_at.append((s, pos, base))
    last = max((s for s, _, _ in store_at if s is not None),
               default=LOOKAHEAD)
    store_at = [(last if s is None else s, pos, base)
                for s, pos, base in store_at]
    for s, _, base in store_at:
        last_read[base] = max(last_read.get(base, -1), s)
    n_steps = last + 1

    # slots: taken at birth, free after the last read; slot 0 is zeros
    births: List[List[int]] = [[] for _ in range(n_steps)]
    for nid, s in born.items():
        births[s].append(nid)
    deaths: List[List[int]] = [[] for _ in range(n_steps + 1)]
    for nid, s in last_read.items():
        if nid != _ZERO:
            deaths[s + 1].append(nid)
    slot: Dict[int, int] = {_ZERO: 0}
    free: List[int] = []
    n_slots = 1
    for s in range(n_steps):
        for nid in deaths[s]:
            heapq.heappush(free, slot[nid])
        for nid in sorted(births[s]):
            if free:
                slot[nid] = heapq.heappop(free)
            else:
                slot[nid], n_slots = n_slots, n_slots + 1

    def off(nid: int) -> int:
        return slot[nid] * SLOT_BYTES

    gate_rows, load_rows, store_rows = [], [], []
    steps = np.zeros((n_steps + 1, 3), np.int32)
    loads_by_step: List[List[int]] = [[] for _ in range(n_steps)]
    for nid in in_pos:
        if nid in born:
            loads_by_step[born[nid]].append(nid)
    stores_by_step: List[List[int]] = [[] for _ in range(n_steps)]
    for s, pos, _ in store_at:
        stores_by_step[s].append(pos)
    pol: Dict[int, int] = {}      # node -> 1 where its slot holds ~node
    for s in range(n_steps):
        steps[s] = (len(gate_rows), len(load_rows), len(store_rows))
        for i in step_gates[s] if s < len(step_gates) else ():
            nid, srcs, is_xor = gates[i]
            args = [(b, c ^ pol.get(b, 0)) for b, c in srcs]
            if is_xor:      # a ^ b ^ c; the complements' parity is kept
                pol[nid] = sum(e for _, e in args) & 1
                (a, _), (b, _), (c, _) = args
                gate_rows.append([off(a) | 1, off(b), off(c), off(nid)])
            else:           # MAJ is self-dual: at most c stays complemented
                flip = int(sum(e for _, e in args) >= 2)
                pol[nid] = flip
                (a, _), (b, _), (c, ec) = sorted(
                    args, key=lambda arg: arg[1] ^ flip)
                gate_rows.append([off(a), off(b), off(c) | (ec ^ flip),
                                  off(nid)])
        for nid in sorted(loads_by_step[s]):
            load_rows.append([*in_pos[nid], off(nid)])
        for pos in sorted(stores_by_step[s]):
            base, comp = outputs[pos]
            store_rows.append([pos, off(base), -(comp ^ pol.get(base, 0))])
    steps[n_steps] = (len(gate_rows), len(load_rows), len(store_rows))

    chunks = [0]
    for s in range(n_steps):
        if steps[s + 1, 0] - steps[chunks[-1], 0] > CHUNK_GATES:
            chunks.append(s)
    chunks.append(n_steps)
    chunk_cap = max(int(steps[b, 0] - steps[a, 0])
                    for a, b in zip(chunks, chunks[1:]))
    mean = len(gates) / max(n_levels, 1)
    warps = int(min(MAX_WARPS, max(MIN_WARPS, round(mean / GATES_PER_WARP))))
    return SlotProgram(
        np.asarray(gate_rows, np.int32).reshape(-1, GATE_INTS),
        np.asarray(load_rows, np.int32).reshape(-1, 3),
        np.asarray(store_rows, np.int32).reshape(-1, 3),
        steps, np.asarray(chunks, np.int32), n_slots,
        sum(b in born for b in in_pos), len(outputs), n_levels, warps,
        any(g[2] for g in gates), chunk_cap)


# lowered programs, keyed by circuit identity (the compiled circuits are
# lru-cached, so each lowers once); device copies per device
_PROGRAMS: Dict[int, Tuple[Circuit, SlotProgram, Dict[str, torch.Tensor]]] = {}


def slot_program(circ: Circuit,
                 input_ids: Sequence[Sequence[int]]) -> SlotProgram:
    """The cached :func:`lower_circuit` of ``circ``."""
    entry = _PROGRAMS.get(id(circ))
    if entry is None or entry[0] is not circ:
        entry = _PROGRAMS[id(circ)] = (circ, lower_circuit(circ, input_ids),
                                       {})
    return entry[1]


def _program_tensor(circ: Circuit, device: torch.device) -> torch.Tensor:
    copies = _PROGRAMS[id(circ)][2]
    key = str(device)
    if key not in copies:
        copies[key] = torch.from_numpy(_PROGRAMS[id(circ)][1].code).to(device)
    return copies[key]


def circuit_plain(circ: Circuit, input_ids: Sequence[Sequence[int]],
                  operand_planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K3: ``Circuit.evaluate_outputs`` on (width_i, W)
    int32 planes; returns (n_outputs, W) int32."""
    w = operand_planes[0].shape[-1]
    dev = operand_planes[0].device
    zero = torch.zeros((w,), dtype=torch.int32, device=dev)
    one = torch.full((w,), -1, dtype=torch.int32, device=dev)
    inputs = {}
    for ids, planes in zip(input_ids, operand_planes):
        for j, nid in enumerate(ids):
            inputs[nid] = planes[j]
    outs = circ.evaluate_outputs(inputs, zero, one)
    if not outs:
        return torch.zeros((0, w), dtype=torch.int32, device=dev)
    return torch.stack(outs)


def _launch(prog: SlotProgram, code: torch.Tensor,
            planes: Sequence[torch.Tensor], out: torch.Tensor) -> None:
    """Launch K3 once: ``code`` is ``prog.code`` on the card, ``planes``
    the contiguous operand planes, ``out`` (n_outputs, W) int32."""
    ptrs = [p.data_ptr() for p in planes]
    ptrs += [ptrs[0]] * (MAX_OPERANDS - len(ptrs))
    build.launch("circuit", "circuit_launch", code.data_ptr(), prog.n_gates,
                 prog.n_steps, int(prog.loads.shape[0]),
                 int(prog.stores.shape[0]), int(prog.chunks.shape[0]) - 1,
                 prog.chunk_cap, prog.n_slots, prog.warps, int(prog.has_xor),
                 *ptrs, out.data_ptr(), out.shape[-1], device=out.device)


def _circuit_kernel(circ: Circuit, input_ids: Sequence[Sequence[int]],
                    operand_planes: Sequence[torch.Tensor]) -> torch.Tensor:
    prog = slot_program(circ, input_ids)
    w = operand_planes[0].shape[-1]
    dev = operand_planes[0].device
    out = torch.empty((prog.n_outputs, w), dtype=torch.int32, device=dev)
    if w == 0 or prog.n_outputs == 0:
        return out
    _launch(prog, _program_tensor(circ, dev),
            [p.contiguous() for p in operand_planes], out)
    build.LAUNCHES["circuit"] += 1
    return out


def circuit_on_planes(circ: Circuit, input_ids: Sequence[Sequence[int]],
                      operand_planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Execute a circuit on vertical-layout operands.

    ``operand_planes[i]`` is (width_i, W) int32, or (S, width_i, W) with a
    leading subarray axis, which folds into the word axis for one launch.
    Returns (n_outputs, W), or (S, n_outputs, W)."""
    if len(operand_planes) != len(input_ids):
        raise ValueError(f"{len(input_ids)} operands expected, got "
                         f"{len(operand_planes)}")
    lead = operand_planes[0].shape[:-2]
    dev = operand_planes[0].device
    flat = []
    for ids, p in zip(input_ids, operand_planes):
        if p.dtype != torch.int32 or p.shape[:-2] != lead or p.device != dev:
            raise ValueError("operand planes must be int32 on one device "
                             "with one leading shape")
        if p.shape[-2] != len(ids):
            raise ValueError(f"operand has {p.shape[-2]} planes, circuit "
                             f"expects {len(ids)}")
        if lead:
            p = p.movedim(-2, 0).reshape(p.shape[-2], -1)
        flat.append(p)
    if dev.type == "cpu":
        out = circuit_plain(circ, input_ids, flat)
    elif dev.type == "cuda":
        out = _circuit_kernel(circ, input_ids, flat)
    else:
        raise ValueError(f"unsupported device {dev}")
    if lead:
        out = out.reshape(out.shape[0], *lead,
                          operand_planes[0].shape[-1]).movedim(0, -2)
    return out
