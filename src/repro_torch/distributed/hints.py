"""Mesh-optional layout hints (counterpart of
:mod:`repro.distributed.hints`).

Model code calls ``hint(x, *spec)`` to pin an intermediate's layout under
a device mesh (``with mesh:``), and the call changes nothing when there
is none (unit tests, CPU runs).  The spec is fitted exactly as the
reference fits it: an axis the mesh lacks, or whose size does not divide
the dim, degrades to None.

The port runs on one card, where every layout is the whole tensor, so a
hint returns ``x`` itself on every mesh.  What it would pin is kept:
:func:`hint_spec` and :func:`hint_kv_spec` return the fitted spec, and
each hint made under a mesh appends (shape, spec) to ``mesh.hints``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..launch.mesh import Mesh, ambient_mesh
from .sharding import P, _axis_size


def hint_spec(mesh: Mesh, shape, *spec) -> P:
    """The spec ``hint`` pins for a tensor of ``shape`` on ``mesh``."""
    names = set(mesh.axis_names)
    fitted = []
    for dim, s in zip(shape, spec):
        if s is None:
            fitted.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        if not set(axes) <= names or dim % _axis_size(mesh, axes) != 0:
            fitted.append(None)
        else:
            fitted.append(s)
    return P(*fitted)


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` with its layout pinned to ``P(*spec)`` (fitted) when a mesh is
    ambient: recorded in ``mesh.hints``; the values are ``x``'s own."""
    mesh = ambient_mesh()
    if mesh is not None:
        mesh.hints.append((tuple(x.shape), hint_spec(mesh, x.shape, *spec)))
    return x


def hint_kv_spec(mesh: Optional[Mesh], shape) -> Optional[tuple]:
    """The (unfitted) spec ``hint_kv`` asks for a (..., B, S, G, hd) KV
    tensor: batch on the DATA axes, kv-heads on ``model`` when they
    divide (else head_dim); None without a ``model`` axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return None
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    data_ax = data if len(data) > 1 else (data[0] if data else None)
    g, hd = shape[-2], shape[-1]
    msize = mesh.shape["model"]
    lead = (None,) * (len(shape) - 4)      # stacked-layer prefix if 5D
    if g % msize == 0:
        return lead + (data_ax, None, "model", None)
    if hd % msize == 0:
        return lead + (data_ax, None, None, "model")
    return lead + (data_ax, None, None, None)


def hint_kv(x: torch.Tensor) -> torch.Tensor:
    """Layout hint for (B, S, G, hd) KV tensors/caches, matching
    :func:`repro_torch.distributed.sharding.cache_shardings` so decode
    steps never reshard the cache.  In a constraint None means
    REPLICATED, so the batch dim is pinned to DATA explicitly."""
    spec = hint_kv_spec(ambient_mesh(), x.shape)
    return x if spec is None else hint(x, *spec)
