"""Device meshes (counterpart of :mod:`repro.launch.mesh`).

A :class:`Mesh` is ordered axis names with their sizes and, for a real
mesh, the devices it spans.  The production meshes (a 16 x 16 pod, two
of them) are abstract: the card's machine has one H100, so they carry
shapes only, which is what the sharding rules and the dry run read.
``with mesh:`` makes a mesh ambient for :mod:`repro_torch.distributed.hints`
and :func:`repro_torch.models.moe.moe_forward_ep`.

A mesh with devices runs one program per position in one process, as
the reference's ``shard_map`` does: position ``k`` computes on
``device_at(k)`` and, on a CUDA device, on its own stream
(``stream_at(k)``, entered with :func:`on_stream`).  Positions may name
one device several times (``cuda:0`` repeated on one card).
"""

from __future__ import annotations

import contextlib
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
        self._streams: dict = {}

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def position(self, **coords: int) -> int:
        """The row-major index of the position at ``coords`` (an axis not
        named is at 0): its place in ``devices``."""
        k = 0
        for a in self.axis_names:
            k = k * self.shape[a] + int(coords.get(a, 0))
        return k

    def device_at(self, k: int, home) -> torch.device:
        """Position ``k``'s device; ``home`` on an abstract mesh.  A CUDA
        device this process does not see raises."""
        if self.abstract:
            return torch.device(home)
        d = torch.device(self.devices[k])
        if d.type == "cuda":
            if not torch.cuda.is_available() or \
                    (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"{self!r} names {d} at position {k}, "
                                 f"which does not exist here")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        return d

    def stream_at(self, k: int, device: torch.device):
        """Position ``k``'s own stream on its CUDA ``device``, made once;
        None on any other device and on an abstract mesh."""
        if self.abstract or device.type != "cuda":
            return None
        s = self._streams.get(k)
        if s is None:
            s = self._streams[k] = torch.cuda.Stream(device=device)
        return s

    def __enter__(self) -> "Mesh":
        self._tokens.append(_AMBIENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.reset(self._tokens.pop())

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else f"over {len(self.devices)}"
        return f"Mesh({self.shape}, {kind})"


@contextlib.contextmanager
def on_stream(device: torch.device, stream):
    """``stream`` made current on ``device``, after it waits for what
    the device's current stream has queued; nothing where ``stream`` is
    None (the CPU, meta, an abstract mesh)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device):
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield


def read_on(t: torch.Tensor, stream) -> torch.Tensor:
    """``t``, marked as read on ``stream`` (where not None), so that the
    caching allocator does not hand its memory out before that read
    ends."""
    if stream is not None and t.device == stream.device:
        t.record_stream(stream)
    return t


def mark(stream):
    """An event recorded on ``stream``: what was queued there so far
    (None where ``stream`` is None)."""
    if stream is None:
        return None
    done = torch.cuda.Event()
    done.record(stream)
    return done


def wait_for(stream, done) -> None:
    """``stream`` waits for the event ``done`` (where both exist)."""
    if stream is not None and done is not None:
        stream.wait_event(done)


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
