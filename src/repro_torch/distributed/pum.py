"""Replay executors of the chip, channel and rank tiers.

Counterpart of :mod:`repro.distributed.pum`.  The reference builds a
tier's executor as a ``shard_map`` over a device mesh (bank slabs over
``data``, chip slabs over ``channel``, channel slabs over ``rank``) when
several devices fit the unit axes, and as a jitted vmap on one device
otherwise; the two are bit-exact.  Here a tier runs on one card: its
executor is the flattened launch of
:mod:`repro_torch.core.control_unit` — every unit of a stacked round in
one K5 launch, or one K6 launch on the fault path — with ``mesh=None``
and ``sharded=False``, which is the reference's single-device path.
Asking for a split across devices (``use_shard_map=True``, or a mesh)
raises, as the reference does on a host with one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from ..core.control_unit import tier_interpreter
from ..core.telemetry import active_tracer


@dataclass(frozen=True)
class ChipExecutor:
    """A tier's replay callable plus how it partitions.

    ``run(states, tables)`` (or, fault-injected, ``run(states, tables,
    keys, stuck0, stuck1, dead, p_flip)``) enqueues the round's launch
    and returns device tensors; ``sharded`` tells whether units run on
    different devices — never here."""

    run: Callable
    mesh: Optional[object]
    sharded: bool

    def describe(self) -> dict:
        """Flat summary for benchmark artifacts."""
        return {"sharded": bool(self.sharded), "devices": 1, "axes": []}


# the reference's name for the channel and rank executors: same shape
ChannelExecutor = ChipExecutor


def _executor(tier: str, units: Tuple[Tuple[str, int], ...], mesh,
              use_shard_map: Optional[bool], device,
              fault: bool = False) -> ChipExecutor:
    """A tier's executor on one card: rounds with one unit axis per entry
    of ``units`` plus the subarrays.  A request to split the units
    across devices raises."""
    grid = " × ".join(f"{name}={n}" for name, n in units)
    if use_shard_map:
        raise ValueError(
            f"shard_map requested but no multi-device mesh fits the {tier} "
            f"tier's {grid}: this port runs a tier on one card")
    if mesh is not None:
        raise ValueError(
            f"a mesh was given for the {tier} tier, but this port splits "
            f"no units across devices; pass mesh=None")
    tr = active_tracer()
    if tr is not None:
        # which executor the tier got, as the reference records it: the
        # single-device path
        tr.event("pum.executor", cat="plan",
                 kind=f"{tier}.faulty" if fault else tier, sharded=False,
                 devices=1)
    return ChipExecutor(tier_interpreter(len(units) + 1, device, fault),
                        None, False)


def make_chip_executor(n_banks: int, mesh=None,
                       use_shard_map: Optional[bool] = None,
                       device="cuda") -> ChipExecutor:
    """The chip's executor: one K5 launch per stacked round."""
    return _executor("chip", (("n_banks", n_banks),), mesh, use_shard_map,
                     device)


def make_faulty_chip_executor(n_banks: int, mesh=None,
                              use_shard_map: Optional[bool] = None,
                              device="cuda") -> ChipExecutor:
    """Fault-injected twin of :func:`make_chip_executor`: one K6 launch
    per attempt of a round, returning ``(states, flip counts)``."""
    return _executor("chip", (("n_banks", n_banks),), mesh, use_shard_map,
                     device, fault=True)


def make_channel_executor(n_chips: int, n_banks: int, mesh=None,
                          use_shard_map: Optional[bool] = None,
                          device="cuda") -> ChannelExecutor:
    """The channel's executor: one K5 launch per stacked super-round."""
    return _executor("channel", (("n_chips", n_chips), ("n_banks", n_banks)),
                     mesh, use_shard_map, device)


def make_faulty_channel_executor(n_chips: int, n_banks: int, mesh=None,
                                 use_shard_map: Optional[bool] = None,
                                 device="cuda") -> ChannelExecutor:
    """Fault-injected twin of :func:`make_channel_executor`: one K6
    launch per attempt of a super-round."""
    return _executor("channel", (("n_chips", n_chips), ("n_banks", n_banks)),
                     mesh, use_shard_map, device, fault=True)


def make_rank_executor(n_channels: int, n_chips: int, n_banks: int,
                       mesh=None, use_shard_map: Optional[bool] = None,
                       device="cuda") -> ChannelExecutor:
    """The rank's executor: one K5 launch per stacked rank round."""
    return _executor("rank", (("n_channels", n_channels),
                              ("n_chips", n_chips), ("n_banks", n_banks)),
                     mesh, use_shard_map, device)
