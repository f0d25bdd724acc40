"""Replay executors of the chip, channel and rank tiers, whole or split
across devices.

Counterpart of :mod:`repro.distributed.pum`.  Units share nothing, so a
tier's stacked round splits along its unit axes: the chip's banks over a
1-D ``("data",)`` mesh, the channel's chips × banks over a 2-D
``("channel", "data")`` mesh, the rank's channels × chips × banks over a
3-D ``("rank", "channel", "data")`` mesh.  Where the reference runs its
vmapped replay under ``shard_map``, a split executor here cuts each
round into the mesh's slabs and makes one K5 (K6) launch a slab on its
position's device and stream
(:func:`repro_torch.core.control_unit.split_tier_interpreter`).  The
unsplit executor is one flattened launch over every unit of the round
(:func:`repro_torch.core.control_unit.tier_interpreter`); the two are
bit-exact.

A mesh is a :class:`repro_torch.launch.mesh.Mesh` with ``devices``.  Its
positions may name the same device several times (``cpu`` repeated in
the tests, ``cuda:0`` repeated on one card, each position on its own
stream); on a host with several cards each slab goes to its own card.
Without a mesh, ``pum_mesh``, ``channel_mesh`` and ``rank_mesh`` build
one over the visible devices of the tier's ``device`` (every CUDA card,
or the one CPU), and return ``None`` where only one device would take
part: the unsplit executor.  Divisibility follows
:func:`repro_torch.distributed.sharding.fit_spec`, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.control_unit import split_tier_interpreter, tier_interpreter
from ..core.telemetry import active_tracer
from ..kernels.build import resolve_device
from ..launch.mesh import Mesh
from .sharding import P, fit_spec


def _note_executor(kind: str, mesh: Optional[Mesh], sharded: bool) -> None:
    """Record which replay executor a tier got (split or not, and over
    how many devices) in the active trace, as the reference does."""
    tr = active_tracer()
    if tr is not None:
        tr.event("pum.executor", cat="plan", kind=kind, sharded=sharded,
                 devices=int(mesh.size) if mesh is not None else 1)


def visible_devices(device="cuda") -> list:
    """The devices a mesh spans by default: every CUDA card for a CUDA
    ``device``, the one CPU for ``"cpu"`` (as
    :func:`repro_torch.launch.mesh.make_host_mesh` finds them)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _devices(devices, device) -> list:
    return list(visible_devices(device) if devices is None else devices)


def pum_mesh(n_banks: int, devices: Optional[Sequence] = None,
             device="cuda") -> Optional[Mesh]:
    """1-D ``("data",)`` mesh over the largest device prefix whose size
    divides ``n_banks`` (equal bank slabs per position).  ``None`` when
    only a single device would take part: the caller then uses the
    unsplit executor."""
    devs = _devices(devices, device)
    size = max((d for d in range(1, len(devs) + 1) if n_banks % d == 0),
               default=1)
    if size <= 1:
        return None
    return Mesh((size,), ("data",), devs[:size])


def channel_mesh(n_chips: int, n_banks: int,
                 devices: Optional[Sequence] = None,
                 device="cuda") -> Optional[Mesh]:
    """2-D ``("channel", "data")`` mesh for a channel's chip × bank grid:
    the largest device grid ``(ch, da)`` with ``ch | n_chips`` and ``da |
    n_banks``, spending devices on ``channel`` at equal totals.  ``None``
    when only a single device would take part."""
    devs = _devices(devices, device)
    best = (1, 1)
    for ch in range(1, len(devs) + 1):
        if n_chips % ch:
            continue
        da = max((d for d in range(1, len(devs) // ch + 1)
                  if n_banks % d == 0), default=1)
        if (ch * da, ch) > (best[0] * best[1], best[0]):
            best = (ch, da)
    ch, da = best
    if ch * da <= 1:
        return None
    return Mesh((ch, da), ("channel", "data"), devs[: ch * da])


def rank_mesh(n_channels: int, n_chips: int, n_banks: int,
              devices: Optional[Sequence] = None,
              device="cuda") -> Optional[Mesh]:
    """3-D ``("rank", "channel", "data")`` mesh for a rank's channel ×
    chip × bank grid: the largest device grid ``(ra, ch, da)`` dividing
    the three counts, spending devices on the outer axes at equal
    totals.  ``None`` when only a single device would take part."""
    devs = _devices(devices, device)
    best = (1, 1, 1)
    for ra in range(1, len(devs) + 1):
        if n_channels % ra:
            continue
        for ch in range(1, len(devs) // ra + 1):
            if n_chips % ch:
                continue
            da = max((d for d in range(1, len(devs) // (ra * ch) + 1)
                      if n_banks % d == 0), default=1)
            if ((ra * ch * da, ra, ch)
                    > (best[0] * best[1] * best[2], best[0], best[1])):
                best = (ra, ch, da)
    ra, ch, da = best
    if ra * ch * da <= 1:
        return None
    return Mesh((ra, ch, da), ("rank", "channel", "data"),
                devs[: ra * ch * da])


def _check_mesh(mesh, device: torch.device) -> None:
    """A mesh a tier can split over: a :class:`Mesh` with devices of the
    tier's device type, each of which exists.  Anything else raises."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"a tier's mesh must be a repro_torch.launch.mesh."
                         f"Mesh with devices, got {type(mesh).__name__}")
    if mesh.abstract:
        raise ValueError(f"mesh {mesh} is abstract: a split needs a mesh "
                         f"with devices")
    for d in mesh.devices:
        d = torch.device(d)
        if d.type != device.type:
            raise ValueError(f"mesh {mesh} names {d}, but the tier runs on "
                             f"{device.type}")
        if d.type == "cuda" and not (
                torch.cuda.is_available()
                and (d.index or 0) < torch.cuda.device_count()):
            raise ValueError(f"mesh {mesh} names {d}, which does not exist "
                             f"here ({torch.cuda.device_count()} CUDA "
                             f"device(s) visible)")


@dataclass(frozen=True)
class ChipExecutor:
    """A tier's replay callable plus how it partitions.

    ``run(states, tables)`` (or, fault-injected, ``run(states, tables,
    keys, stuck0, stuck1, dead, p_flip)``) enqueues the round's launches;
    ``sharded`` tells whether unit slabs run at the mesh's positions (one
    launch a slab) or the whole round runs in one launch."""

    run: Callable
    mesh: Optional[Mesh]
    sharded: bool

    def describe(self) -> dict:
        """Flat summary for telemetry and benchmark artifacts."""
        return {
            "sharded": bool(self.sharded),
            "devices": int(self.mesh.size) if self.mesh is not None else 1,
            "axes": list(self.mesh.axis_names) if self.mesh is not None
            else [],
        }


# the reference's name for the channel and rank executors: same shape
ChannelExecutor = ChipExecutor


def _executor(kind: str, units: Tuple[Tuple[str, str, int], ...],
              default_mesh: Callable, mesh, use_shard_map: Optional[bool],
              device, fault: bool = False) -> ChipExecutor:
    """The selection of the reference's ``make_*_executor``.  ``units``
    holds (mesh axis, count name, count) of each split unit axis, outer
    first; rounds carry one more unit axis, the subarrays.

    ``use_shard_map``: ``None`` splits whenever a multi-device mesh fits
    the unit axes, ``True`` requires it (raises if none fits), ``False``
    forces the unsplit executor."""
    dev = resolve_device(device)
    n_lead = len(units) + 1
    name = f"{kind}.faulty" if fault else kind
    if use_shard_map is False:
        _note_executor(name, None, False)
        return ChipExecutor(tier_interpreter(n_lead, dev, fault), None, False)
    axes = tuple(a for a, _, _ in units)
    if mesh is None:
        mesh = default_mesh(*(n for _, _, n in units), device=dev)
    else:
        _check_mesh(mesh, dev)
    has_axes = mesh is not None and set(axes) <= set(mesh.axis_names)
    spec = (fit_spec(mesh, [n for _, _, n in units], *axes) if has_axes
            else P(*[None] * len(axes)))
    fits = has_axes and tuple(spec) == axes and (
        mesh.shape["data"] > 1 if len(axes) == 1 else mesh.size > 1)
    if not fits:
        if use_shard_map:
            grid = (f"({', '.join(axes)}) " if len(axes) > 1 else "")
            counts = " × ".join(f"{c}={n}" for _, c, n in units)
            raise ValueError(
                f"shard_map requested but no multi-device {grid}mesh fits "
                f"{counts} (devices={len(visible_devices(dev))})")
        _note_executor(name, mesh, False)
        return ChipExecutor(tier_interpreter(n_lead, dev, fault), mesh, False)
    _note_executor(name, mesh, True)
    return ChipExecutor(split_tier_interpreter(n_lead, mesh, axes, dev,
                                               fault), mesh, True)


def make_chip_executor(n_banks: int, mesh: Optional[Mesh] = None,
                       use_shard_map: Optional[bool] = None,
                       device="cuda") -> ChipExecutor:
    """The chip's executor: one K5 launch per stacked round, or one per
    bank slab of a ``("data",)`` mesh."""
    return _executor("chip", (("data", "n_banks", n_banks),), pum_mesh,
                     mesh, use_shard_map, device)


def make_faulty_chip_executor(n_banks: int, mesh: Optional[Mesh] = None,
                              use_shard_map: Optional[bool] = None,
                              device="cuda") -> ChipExecutor:
    """Fault-injected twin of :func:`make_chip_executor`: one K6 launch
    per attempt of a round (per slab, split), returning ``(states, flip
    counts)``; the fault operands split with the state slabs."""
    return _executor("chip", (("data", "n_banks", n_banks),), pum_mesh,
                     mesh, use_shard_map, device, fault=True)


def make_channel_executor(n_chips: int, n_banks: int,
                          mesh: Optional[Mesh] = None,
                          use_shard_map: Optional[bool] = None,
                          device="cuda") -> ChannelExecutor:
    """The channel's executor: one K5 launch per stacked super-round, or
    one per chip × bank slab of a ``("channel", "data")`` mesh."""
    return _executor("channel", (("channel", "n_chips", n_chips),
                                 ("data", "n_banks", n_banks)),
                     channel_mesh, mesh, use_shard_map, device)


def make_faulty_channel_executor(n_chips: int, n_banks: int,
                                 mesh: Optional[Mesh] = None,
                                 use_shard_map: Optional[bool] = None,
                                 device="cuda") -> ChannelExecutor:
    """Fault-injected twin of :func:`make_channel_executor`: one K6
    launch per attempt of a super-round (per slab, split)."""
    return _executor("channel", (("channel", "n_chips", n_chips),
                                 ("data", "n_banks", n_banks)),
                     channel_mesh, mesh, use_shard_map, device, fault=True)


def make_rank_executor(n_channels: int, n_chips: int, n_banks: int,
                       mesh: Optional[Mesh] = None,
                       use_shard_map: Optional[bool] = None,
                       device="cuda") -> ChannelExecutor:
    """The rank's executor: one K5 launch per stacked rank round, or one
    per channel × chip × bank slab of a ``("rank", "channel", "data")``
    mesh.  The rank has no faulty executor, as in the reference."""
    return _executor("rank", (("rank", "n_channels", n_channels),
                              ("channel", "n_chips", n_chips),
                              ("data", "n_banks", n_banks)),
                     rank_mesh, mesh, use_shard_map, device)
