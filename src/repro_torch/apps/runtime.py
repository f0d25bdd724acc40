"""Shared runtime for the seven application kernels (paper §5).

Counterpart of ``repro.apps.runtime``.  Every app builds a
:class:`~repro_torch.core.bank.BbopInstr` queue — one
producer→consumer ``Ref`` chain per lane shard — and drains it through
:meth:`repro_torch.core.isa.SimdramDevice.dispatch`, so the SAME kernel code
exercises the whole backend ladder:

  "bitplane"   per-instruction sequential drain (pack → K3 → unpack)
  "cuda"       per-instruction sequential drain on the hand-kernel fast
               path (K1 → K3 → K2)
  "bank"       fused heterogeneous waves across the bank's subarrays,
               one K5 launch a wave
  "chip"       per-bank partitioned rounds, one K5 launch a round
  "channel"    per-chip super-rounds, one K5 launch a super-round,
               host↔chip transfers priced at cfg.channel_bw_gbs

Ref-connected chains are indivisible under the chip/channel LPT
partitioners (forwarded bit-planes never cross banks or chips), so an
app that wants tier parallelism must emit SEVERAL independent chains —
:func:`shard_slices` splits the lane space into one chain per compute
unit (:func:`n_parallel_units`).  Results stay bit-exact for any shard
count; sharding only changes the schedule.

In the apps ``device=`` is a :class:`SimdramDevice`, as in the
reference; where its tensors live is ``torch_device`` (default
``"cuda"``, which raises without a card; ``"cpu"`` runs the plain
versions).

Correctness reporting: apps verify against their numpy oracle with
:func:`verify` — a real raising check (``python -O`` strips bare
``assert`` statements, the seed-era bug) — and surface ``verified:
True`` in their result dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.bank import BbopInstr, Ref
from ..core.isa import SimdramDevice

#: the backend ladder every app is bit-exactness-gated across
LADDER = ("bitplane", "bank", "chip", "channel")


class AppVerificationError(AssertionError):
    """An app kernel's SIMDRAM output diverged from its numpy oracle."""


def verify(ok: bool, message: str, got=None, want=None) -> None:
    """Raising correctness check (survives ``python -O``, unlike a bare
    ``assert``)."""
    if ok:
        return
    if got is not None or want is not None:
        message = f"{message} (got={got!r}, want={want!r})"
    raise AppVerificationError(message)


def resolve_device(device: Optional[SimdramDevice], backend: str,
                   cfg=None, style: str = "mig",
                   torch_device: str = "cuda") -> SimdramDevice:
    """An explicit ``device`` wins; otherwise build one for ``backend``
    (the apps' backend parameter — no more hardcoded seed-era
    ``backend="bitplane"``) whose tensors live on ``torch_device``."""
    if device is not None:
        return device
    kw = dict(backend=backend, style=style, device=torch_device)
    if cfg is not None:
        kw["cfg"] = cfg
    return SimdramDevice(**kw)


def n_parallel_units(dev: SimdramDevice) -> int:
    """How many independent Ref chains the device's backend can work on
    concurrently: chains are indivisible under the chip/channel
    partitioners, so this is the count of (chip ×) bank × subarray slots
    — 1 for the sequential single-subarray backends (``cuda`` among
    them) and for ``rank``, as in the reference."""
    cfg = dev.cfg
    per_chip = cfg.n_banks * cfg.subarrays_per_bank
    return {"bank": per_chip, "chip": per_chip,
            "channel": cfg.n_chips * per_chip}.get(dev.backend, 1)


def shard_slices(n: int, units: int, min_lanes: int = 32) -> List[slice]:
    """Split ``n`` lanes into up to ``units`` contiguous shards of at
    least ``min_lanes`` each (tiny shards waste replay slots)."""
    if n <= 0:
        return []
    k = max(1, min(units, n // min_lanes or 1))
    per = -(-n // k)
    return [slice(s, min(s + per, n)) for s in range(0, n, per)]


class QueueBuilder:
    """Accumulates one dispatch queue; :meth:`emit` returns the ``Ref``
    that forwards the new instruction's first output vertically into a
    later instruction."""

    def __init__(self):
        self.queue: List[BbopInstr] = []

    def emit(self, op: str, *operands, n_bits: int,
             signed_out: bool = False, keep_vertical: bool = False) -> Ref:
        self.queue.append(
            BbopInstr(op, tuple(operands), int(n_bits),
                      signed_out=signed_out, keep_vertical=keep_vertical))
        return Ref(len(self.queue) - 1, 0)

    def __len__(self) -> int:
        return len(self.queue)


def take(results: Sequence, ref: Ref) -> np.ndarray:
    """Pull one dispatched result as a flat int64 array."""
    r = results[ref.producer]
    vals = r[ref.out] if isinstance(r, tuple) else r
    return np.asarray(vals).astype(np.int64)


def gather(results: Sequence, shards, n: int) -> np.ndarray:
    """Reassemble per-shard results: ``shards`` is [(slice, Ref), ...]
    covering ``[0, n)``."""
    out = np.zeros(n, np.int64)
    for sl, ref in shards:
        out[sl] = take(results, ref)
    return out


def engine_stats_object(dev: SimdramDevice):
    """The backend engine's live Stats object — ``None`` for the
    engine-less sequential backends.  For the registry form pass this to
    :func:`repro_torch.core.telemetry.publish_stats`."""
    if dev.backend == "bank":
        return dev.bank().stats
    if dev.backend == "chip":
        return dev.chip().stats
    if dev.backend == "channel":
        return dev.channel().stats
    return None


def engine_stats(dev: SimdramDevice) -> Optional[Dict]:
    """The backend engine's own stats dict (wave fusion, rounds,
    transfers, measured wall) — ``None`` for the engine-less sequential
    backends, whose only model is the device-level :meth:`totals`."""
    stats = engine_stats_object(dev)
    return stats.as_dict() if stats is not None else None
