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

The reference runs one stage per device under ``shard_map`` and hops
activations with ``ppermute``.  Here, on a mesh with devices, stage
``s`` runs at the position of ``axis`` = ``s`` (the other axes at 0),
in one process: its parameters move once to that position's device,
it computes on the position's own stream, and its output hops to stage
``s + 1``'s device after an event that stream waits on.  The last
stage's outputs come back on ``x``'s device, the reference's
psum-broadcast seen from one process.  Positions may repeat a device
(``cuda:0`` repeated on one card; NCCL refuses two ranks on one card).
On an abstract mesh every stage runs on ``x``'s device and the caller's
stream.  Autograd gives the reverse-schedule backward, each op's
backward on the stream its forward ran on.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch.mesh import Mesh, mark, on_stream, read_on, wait_for
from ..models.params import tree_leaves, tree_map


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
    Returns the pipeline output (B, ...) on ``x``'s device.
    """
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    micro = x.reshape(n_micro, mb, *x.shape[1:])
    home = x.device
    pos = [mesh.position(**{axis: s}) for s in range(n_stages)]
    devs = [mesh.device_at(k, home) for k in pos]
    streams = [mesh.stream_at(k, d) for k, d in zip(pos, devs)]
    stages = [tree_map(lambda t: t[s].to(devs[s]), stacked_params)
              for s in range(n_stages)]
    for stage, stream in zip(stages, streams):
        for p in tree_leaves(stage):
            read_on(p, stream)
    # what stage s reads next tick: (activation, the event after which it
    # is ready); zeros before anything arrives
    recv = [(torch.zeros((mb, *x.shape[1:]), dtype=x.dtype, device=d), None)
            for d in devs]
    outs = []
    for t in range(n_micro + n_stages - 1):
        sent = []
        for s in range(n_stages):
            with on_stream(devs[s], streams[s]):
                if s == 0:
                    h = read_on(micro[min(t, n_micro - 1)],
                                streams[0]).to(devs[0])
                else:
                    h, ready = recv[s]
                    wait_for(streams[s], ready)
                    h = read_on(h, streams[s]).to(devs[s])
                y = stage_fn(stages[s], h)
                sent.append((y, mark(streams[s])))
        # hop: stage s -> s+1 (stage 0 receives nothing)
        recv = [recv[0]] + sent[:-1]
        if t >= n_stages - 1:
            outs.append(sent[-1])
    cur = torch.cuda.current_stream(home) if home.type == "cuda" else None
    for y, done in outs:
        wait_for(cur, done)
        read_on(y, cur)
    return torch.cat([y.to(home) for y, _ in outs], dim=0)


def split_stages(stacked_layer_params, n_stages: int):
    """(L, ...)-stacked layer params -> (S, L/S, ...) stage-stacked."""
    def re(t):
        l = t.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} stages")
        return t.reshape(n_stages, l // n_stages, *t.shape[1:])
    return tree_map(re, stacked_layer_params)
