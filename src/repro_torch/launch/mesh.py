"""Device meshes (counterpart of :mod:`repro.launch.mesh`).

A :class:`Mesh` is ordered axis names with their sizes and, for a real
mesh, the devices it spans.  The production meshes (a 16 x 16 pod, two
of them) are abstract: the card's machine has one H100, so they carry
shapes only, which is what the sharding rules and the dry run read.
``with mesh:`` makes a mesh ambient for :mod:`repro_torch.distributed.hints`.
"""

from __future__ import annotations

import contextvars
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels.build import resolve_device

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


class Mesh:
    """``axis_names`` with sizes ``axis_sizes`` (``.shape`` maps each name
    to its size, in order) over ``devices``, one per position in
    row-major order, or ``None`` for an abstract mesh.  ``hints`` keeps
    (shape, fitted spec) of every hint made while the mesh was ambient."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, axis_sizes)))
        self.size = math.prod(self.shape.values())
        self.devices = None if devices is None else tuple(devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")
        self.hints: list = []
        self._tokens: list = []

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def __enter__(self) -> "Mesh":
        self._tokens.append(_AMBIENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.reset(self._tokens.pop())

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else f"over {len(self.devices)}"
        return f"Mesh({self.shape}, {kind})"


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _AMBIENT.get()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256-chip pod ("data", "model"); 2 x 16 x 16 = 512-chip
    two-pod mesh ("pod", "data", "model").  Abstract: no such devices
    exist on the port's machine."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """("data", "model") mesh over the visible devices of ``device``'s
    type: every CUDA card, or the one CPU.  Raises where
    ``model_parallel`` does not divide their number."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {n} visible {dev.type} device(s)")
    return Mesh((n // model_parallel, model_parallel), ("data", "model"),
                devices)
