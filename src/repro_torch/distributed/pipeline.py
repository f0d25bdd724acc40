"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
:mod:`repro.distributed.pipeline`).

Stages are contiguous layer groups whose stacked params have a leading
stage axis.  The schedule is the classic GPipe fill/drain:
``n_ticks = n_micro + n_stages - 1``; at tick ``t`` stage 0 takes
microbatch ``t`` (the last one again once they run out) and stage ``s``
takes what stage ``s - 1`` produced at tick ``t - 1`` (zeros before
anything arrives).  Every stage computes every tick, bubbles included,
as the reference's SPMD program does.  The output is the last stage's
outputs from tick ``S - 1`` on, one microbatch each.

The reference runs one stage per rank and hops activations with
``ppermute``.  The port's machine has one GPU, and NCCL refuses two
ranks on one card, so the stages run in one process, one after another
within a tick; autograd gives the reverse-schedule backward.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch.mesh import Mesh
from ..models.params import tree_map


def gpipe(
    stage_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "pod",
    n_micro: int = 4,
) -> torch.Tensor:
    """Run ``stage_fn(stage_params, h) -> h`` as a pipeline of
    ``mesh.shape[axis]`` stages.

    stacked_params: tree with leading dim = n_stages.
    x: (B, ...) batch input; B % n_micro == 0.
    Returns the pipeline output (B, ...).
    """
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    stream = x.reshape(n_micro, mb, *x.shape[1:])
    stages = [tree_map(lambda t: t[s], stacked_params)
              for s in range(n_stages)]
    recv = [torch.zeros_like(stream[0]) for _ in range(n_stages)]
    outs = []
    for t in range(n_micro + n_stages - 1):
        ys = [stage_fn(stages[s], stream[min(t, n_micro - 1)] if s == 0
                       else recv[s]) for s in range(n_stages)]
        # hop: stage s -> s+1 (stage 0 receives nothing)
        recv = [recv[0]] + ys[:-1]
        if t >= n_stages - 1:
            outs.append(ys[-1])
    return torch.cat(outs, dim=0)


def split_stages(stacked_layer_params, n_stages: int):
    """(L, ...)-stacked layer params -> (S, L/S, ...) stage-stacked."""
    def re(t):
        l = t.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} stages")
        return t.reshape(n_stages, l // n_stages, *t.shape[1:])
    return tree_map(re, stacked_layer_params)
