"""μProgram ISA and DRAM row organization (SIMDRAM Step 2 output).

Row address space of one compute-enabled subarray (Ambit-style B/C/D
groups, which SIMDRAM builds on):

  B-group (compute rows):
    T0..T3          4 regular compute rows
    DCC0, DCC1      2 dual-contact-cell rows.  Each DCC row is one physical
                    row reachable through two wordlines: the *d*-port
                    (stores x) and the *n*-port (reads/writes ~x).  This is
                    the substrate's free NOT.
  C-group: C0 (all zeros), C1 (all ones) — constant rows.
  D-group: regular data rows — operand bit-rows (vertical layout: bit i of
    every SIMD lane lives in one D row), output rows, and allocator scratch.

Commands (the two DRAM primitives the memory controller issues):

  AAP(src, dst)   "activate-activate-precharge": RowClone copy src→dst
                  (2 row activations + 1 precharge;  t ≈ 2·tRAS + tRP).
  AP(triple)      "activate-precharge" triple-row activation: the three
                  rows of a predefined B-group triple charge-share and all
                  end up holding MAJ of their initial values
                  (t ≈ tRAS + tRP).

Row references carry a polarity bit: ``(row, neg=True)`` addresses the
n-port of a DCC row (reads ~x / writes-through-inversion).  Regular rows
only support ``neg=False``.

A :class:`UProgram` is the fully-resolved command sequence for one
operation, plus the operand→row map — exactly what SIMDRAM's control unit
stores in its μProgram memory and replays on a ``bbop`` instruction.
"""

from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --- physical row indices ----------------------------------------------------
T0, T1, T2, T3 = 0, 1, 2, 3
DCC0, DCC1 = 4, 5
C0, C1 = 6, 7
N_SPECIAL = 8           # first D-group row index
B_ROWS = (T0, T1, T2, T3, DCC0, DCC1)
DCC_ROWS = (DCC0, DCC1)

ROW_NAMES = {T0: "T0", T1: "T1", T2: "T2", T3: "T3",
             DCC0: "DCC0", DCC1: "DCC1", C0: "C0", C1: "C1"}


def row_name(r: int) -> str:
    return ROW_NAMES.get(r, f"D{r - N_SPECIAL}")


# RowRef: (physical_row, negated_port)
RowRef = Tuple[int, bool]

# Predefined TRA triples the B-group row decoder can activate simultaneously
# (mirrors Ambit's triple-row-activation address set; DCC n-ports appear in
# two of them so a negated operand feeds a MAJ without an extra copy).
TRIPLES: Tuple[Tuple[RowRef, RowRef, RowRef], ...] = (
    ((T0, False), (T1, False), (T2, False)),
    ((T1, False), (T2, False), (T3, False)),
    ((DCC0, True), (T1, False), (T2, False)),
    ((DCC1, True), (T0, False), (T3, False)),
)


@dataclass(frozen=True)
class Command:
    kind: str                 # "AAP" | "AP"
    src: Optional[RowRef] = None      # AAP only
    dst: Optional[RowRef] = None      # AAP only
    triple: Optional[int] = None      # AP only: index into TRIPLES

    def __repr__(self) -> str:
        if self.kind == "AAP":
            s = row_name(self.src[0]) + ("n" if self.src[1] else "")
            d = row_name(self.dst[0]) + ("n" if self.dst[1] else "")
            return f"AAP({s} -> {d})"
        t = TRIPLES[self.triple]
        rows = ",".join(row_name(r) + ("n" if n else "") for r, n in t)
        return f"AP({rows})"


@dataclass
class UProgram:
    """Compiled command sequence for one SIMDRAM operation."""

    op_name: str
    n_bits: int
    commands: List[Command]
    # operand i, bit j  ->  D-group physical row holding that bit-row
    in_rows: List[List[int]]
    # output o, bit j   ->  D-group physical row the result lands in
    out_rows: List[List[int]]
    n_rows_total: int          # physical rows incl. scratch
    n_scratch: int

    # -- cost accounting (drives timing/energy/throughput models) ---------
    # command-mix counts are memoized: the dispatch hot path consults
    # them per wave, and a μProgram's command list never mutates after
    # compilation (compaction builds a NEW UProgram)
    @functools.cached_property
    def n_aap(self) -> int:
        return sum(1 for c in self.commands if c.kind == "AAP")

    @functools.cached_property
    def n_ap(self) -> int:
        return sum(1 for c in self.commands if c.kind == "AP")

    @property
    def n_activations(self) -> int:
        # AAP = 2 ACTs, AP = 1 (triple) ACT
        return 2 * self.n_aap + self.n_ap

    def stats(self) -> Dict[str, int]:
        return {
            "AAP": self.n_aap,
            "AP": self.n_ap,
            "total_cmds": len(self.commands),
            "activations": self.n_activations,
            "scratch_rows": self.n_scratch,
        }

    def listing(self) -> str:
        return "\n".join(f"{i:4d}: {c!r}" for i, c in enumerate(self.commands))


# ---------------------------------------------------------------------------
# μProgram compaction: a peephole pass over AAP/AP command sequences
# ---------------------------------------------------------------------------
#
# The paper's first-order cost metric is the activation count (1 AAP =
# 2 ACTs, 1 AP = 1 triple ACT), and the Step-2 allocator's greedy
# scheduling leaves removable commands behind: values staged through a
# scratch row and immediately re-copied (RowClone chains), rows written
# and then overwritten before any read, and self-copies that change
# nothing.  The pass below is removal/redirection-only — it can never
# increase the activation count — and preserves the μProgram's
# *semantics*: the operand-rows → output-rows mapping is bit-exact
# (non-output scratch rows may legitimately end in a different state).
#
# Three sub-passes iterate to a fixpoint:
#
#   copy propagation   AAP(a→d) ... AAP(d→y)  ⇒  ... AAP(a→y) when
#                      neither a nor d was rewritten in between (the
#                      redirect honors port physics: a negated read is
#                      only introduced on DCC rows);
#   NOP squeezing      AAP whose written value provably equals the
#                      destination's current content is dropped (this
#                      covers self-copies and re-copies of an unchanged
#                      source — and the all-zero AAP(T0→T0) NOP padding
#                      word, so padded tables compact too);
#   dead-write elim    backward liveness from the output rows: an AAP
#                      whose destination is never read again is dropped;
#                      an AP none of whose three rows is ever read again
#                      is dropped.


def _ap_rows(triple_idx: int) -> Set[int]:
    return {r for r, _ in TRIPLES[triple_idx]}


def _invalidate(copies: Dict[int, Tuple[int, bool]], row: int) -> None:
    """Row ``row`` was overwritten: forget its copy record, and re-root
    any equivalence class it anchored onto a surviving member (those
    rows still hold the OLD value — only the anchor changed)."""
    copies.pop(row, None)
    orphans = [(r, p) for r, (root, p) in copies.items() if root == row]
    for r, _p in orphans:
        del copies[r]
    if len(orphans) >= 2:
        new_root, root_pol = orphans[0]
        for r, p in orphans[1:]:
            copies[r] = (new_root, p ^ root_pol)


def _propagate_copies(commands: Sequence[Command]) -> Tuple[List[Command], bool]:
    """Forward pass: redirect AAP reads to the oldest still-valid copy
    root and drop AAPs that rewrite a row with its current content."""
    # copies[r] = (root, pol): content[r] == content[root] ^ pol and
    # neither r nor root has been written since the record was made.
    copies: Dict[int, Tuple[int, bool]] = {}
    out: List[Command] = []
    changed = False
    for c in commands:
        if c.kind != "AAP":
            rows = sorted(TRIPLES[c.triple], key=lambda rn: rn[0])
            for r, _n in rows:
                _invalidate(copies, r)
            # charge-sharing leaves ALL THREE rows holding the MAJ value
            # (n-port slots store the complement): one equivalence class
            (r0, n0) = rows[0]
            for r, n in rows[1:]:
                copies[r] = (r0, n ^ n0)
            out.append(c)
            continue
        (rs, ns), (rd, nd) = c.src, c.dst
        root, pol = copies.get(rs, (rs, False))
        eff_neg = pol ^ ns
        # redirect the read to the chain root when the port exists:
        # plain reads work on any row, negated reads only on DCC rows
        if (root, eff_neg) != (rs, ns) and (not eff_neg or root in DCC_ROWS):
            rs, ns = root, eff_neg
            changed = True
        # the value this AAP writes, expressed against the copy root
        vroot, vpol = copies.get(rs, (rs, False))
        vpol ^= ns ^ nd
        if (vroot, vpol) == copies.get(rd, (rd, False)):
            changed = True          # destination already holds the value
            continue
        out.append(Command("AAP", src=(rs, ns), dst=(rd, nd)))
        _invalidate(copies, rd)
        if vroot != rd:
            copies[rd] = (vroot, vpol)
    return out, changed


def _eliminate_dead_writes(
    commands: Sequence[Command], live_out: Iterable[int]
) -> Tuple[List[Command], bool]:
    """Backward liveness: drop commands whose writes are never read."""
    live: Set[int] = set(live_out)
    kept: List[Command] = []
    changed = False
    for c in reversed(commands):
        if c.kind == "AAP":
            rs, rd = c.src[0], c.dst[0]
            if rd not in live:
                changed = True
                continue
            if rs != rd:
                live.discard(rd)    # fully overwritten here
            live.add(rs)
        else:
            rows = _ap_rows(c.triple)
            if not live & rows:
                changed = True
                continue
            # an AP also writes its rows, but the read happens first, so
            # in backward order the gen always wins — rows stay live
            live |= rows
        kept.append(c)
    kept.reverse()
    return kept, changed


# RowHammer tolerance (paper §4): the test-suite's long-standing bound on
# consecutive same-row activations in a compiled stream.  Compaction may
# merge streaks up to this floor — or up to the allocator's own streak if
# that is already larger — but never beyond (synthesis.compact enforces
# it, scripts/check_compaction.py and tests/test_compaction.py gate it).
ROWHAMMER_STREAK_BOUND = 8


def max_activation_streak(commands: Sequence[Command]) -> int:
    """Longest run of consecutive commands sharing a physical row — the
    RowHammer exposure metric the Step-2 allocator bounds by
    construction (paper §4).  Removing the commands *between* two
    touches of one row merges their streaks, so
    :func:`repro_torch.core.synthesis.compact` rejects any compacted stream
    whose streak exceeds ``max(original streak,
    ROWHAMMER_STREAK_BOUND)``."""
    streak = worst = 0
    prev: Optional[Set[int]] = None
    for c in commands:
        rows = ({c.src[0], c.dst[0]} if c.kind == "AAP"
                else _ap_rows(c.triple))
        if prev is not None and prev & rows:
            streak += 1
            worst = max(worst, streak)
        else:
            streak = 0
        prev = rows
    return worst


def _access_lists(commands: Sequence[Command]) -> Dict[int, List[Tuple[int, str]]]:
    """Per physical row, the ordered (cmd_idx, kind) accesses; kind is
    "r" (read), "w" (write) or "rw" (AP charge-sharing / self-copy)."""
    acc: Dict[int, List[Tuple[int, str]]] = {}
    for i, c in enumerate(commands):
        if c.kind == "AAP":
            rs, rd = c.src[0], c.dst[0]
            if rs == rd:
                acc.setdefault(rs, []).append((i, "rw"))
            else:
                acc.setdefault(rs, []).append((i, "r"))
                acc.setdefault(rd, []).append((i, "w"))
        else:
            for r in _ap_rows(c.triple):
                acc.setdefault(r, []).append((i, "rw"))
    return acc


def _forward_stores(
    commands: Sequence[Command], live_out: Set[int]
) -> Tuple[List[Command], bool]:
    """Store forwarding: ``AAP(src→d) … AAP(d→y)`` where *d*'s only use
    is that one re-copy becomes ``AAP(src→y)`` — the RowClone chain
    through the intermediate row collapses.  Safe when nothing touches
    *y* in between (the write moves earlier), the re-copy is the next
    access to *d*, and *d* is dead afterwards (its next access is a
    fresh write, or it is never accessed again and is not an output
    row).  Port physics: a polarity-changing retarget is only allowed
    when the final write lands on a DCC row."""
    cmds = list(commands)
    changed = False
    while True:
        acc = _access_lists(cmds)
        # each row's access indices, ascending: a command's place in its
        # row's list, and whether a row is touched inside a window, are
        # binary searches
        at = {row: [i for i, _k in lst] for row, lst in acc.items()}
        applied = False
        for i, c in enumerate(cmds):
            if c.kind != "AAP" or c.src[0] == c.dst[0]:
                continue
            d, nd = c.dst
            lst = acc.get(d, [])
            pos = bisect.bisect_left(at[d], i)
            if pos + 1 >= len(lst):
                continue
            j, jkind = lst[pos + 1]
            if jkind != "r":                   # next access must be a pure read
                continue
            cj = cmds[j]
            y, ny = cj.dst
            nsj = cj.src[1]
            pol = nd ^ nsj ^ ny
            if pol and y not in DCC_ROWS:
                continue                       # no negating write port on y
            yat = at.get(y, [])
            first = bisect.bisect_right(yat, i)
            if first < len(yat) and yat[first] < j:
                continue                       # y is touched before the re-copy
            # d must be dead after j: next access is a fresh write, or none
            if pos + 2 < len(lst):
                k, kkind = lst[pos + 2]
                if kkind != "w":
                    continue
            elif d in live_out:
                continue
            cmds[i] = Command("AAP", src=c.src, dst=(y, pol))
            del cmds[j]
            applied = changed = True
            break
        if not applied:
            return cmds, changed


def compact_commands(
    commands: Sequence[Command], live_out: Iterable[int],
    max_iters: int = 8,
) -> List[Command]:
    """Fixpoint-iterate copy propagation + NOP squeezing + store
    forwarding + dead-write elimination.  ``live_out`` is the set of
    physical rows whose final content the program's outputs read
    (everything else is scratch)."""
    cur = list(commands)
    live = set(live_out)
    for _ in range(max_iters):
        # store forwarding first: copy propagation's read-redirects can
        # break the single-use chains it collapses (measured on the op
        # library — this order compacts strictly more)
        cur, c1 = _forward_stores(cur, live)
        cur, c2 = _eliminate_dead_writes(cur, live)
        cur, c3 = _propagate_copies(cur)
        cur, c4 = _eliminate_dead_writes(cur, live)
        if not (c1 or c2 or c3 or c4):
            break
    return cur
