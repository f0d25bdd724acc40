"""Collective/overlap helpers (counterpart of
:mod:`repro.distributed.collectives`).

- :func:`constrain` and :func:`sequence_parallel_norm` pin activation
  layouts at block boundaries, as hints do (:mod:`.hints`): they record
  the fitted spec under a mesh and change no value;
- :func:`async_allreduce_scan`: microbatch gradient accumulation in which
  each microbatch's all-reduce is issued asynchronously as soon as its
  gradients exist, and waited on only before they are added, so the
  reduction overlaps the next microbatch's backward (the reference's
  psum inside the scan body, the classic DP overlap);
- :func:`pod_psum_compressed`: the int8 compressed all-reduce of
  :mod:`repro_torch.train.compression` over the ``pod`` process group.

The collectives run over a ``torch.distributed`` process group (the
reference's mesh axis): ``group`` names it, the default the world.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh
from ..models.params import tree_leaves, tree_map
from .hints import hint


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    return hint(x, *spec)


def sequence_parallel_norm(norm_fn: Callable, x: torch.Tensor,
                           seq_axis: str = "model") -> torch.Tensor:
    """Run a norm with the sequence dim sharded on `seq_axis` (SP): cheap
    elementwise work is distributed instead of replicated across TP ranks."""
    x = constrain(x, None, seq_axis, None)
    y = norm_fn(x)
    return constrain(y, None, seq_axis, None)


def async_allreduce_scan(grad_fn: Callable, params: Any, microbatches: Any,
                         group=None) -> Any:
    """Sum over the microbatches (the leading axis of every leaf of
    ``microbatches``) of ``grad_fn(params, mb)``, each all-reduced (sum)
    over ``group``, accumulated in float32 in microbatch order.
    Microbatch i's all-reduce is in flight while microbatch i+1's
    gradients are computed."""
    if not dist.is_initialized():
        raise RuntimeError(
            "async_allreduce_scan needs an initialized torch.distributed "
            "process group (torch.distributed.init_process_group)")
    n = next(tree_leaves(microbatches)).shape[0]
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    pending = None

    def land(grads, handles):
        for h in handles:
            h.wait()
        tree_map(lambda a, g: a.add_(g), acc, grads)

    for i in range(n):
        g = grad_fn(params, tree_map(lambda t: t[i], microbatches))
        handles = [dist.all_reduce(t, group=group, async_op=True)
                   for t in tree_leaves(g)]
        if pending is not None:
            land(*pending)
        pending = (g, handles)
    if pending is not None:
        land(*pending)
    return acc


def pod_psum_compressed(mesh: Mesh, x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce of this rank's ``x`` across pods (see
    :func:`repro_torch.train.compression.compressed_psum`): ``x`` itself
    on a mesh without a ``pod`` axis; otherwise the sum over ``group``,
    the ranks of one position in the other axes, one per pod."""
    from ..train.compression import compressed_psum

    if "pod" not in mesh.axis_names:
        return x
    return compressed_psum(x, group)
