"""AdamW + schedules + global-norm clipping over param trees (counterpart
of :mod:`repro.train.optimizer`).

Moments are fp32 regardless of param dtype (bf16 params, fp32 m/v — the
standard large-scale recipe); update math runs in fp32 and casts back.
:func:`update` is functional: it returns new trees and leaves its
arguments as they were.  Everything stays on the params' device as
tensors (the step, lr and norm too), so a step never waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.params import flatten, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def init(params: Any) -> OptState:
    """Zero moments (fp32) and step 0 (int32), on the params' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = flatten(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    s = step.to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, frac)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares (fp32), summed leaf by leaf in the
    reference's leaf order."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in flatten(tree)]
    return torch.sqrt(sum(leaves))


def update(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``gnorm`` is the gradients' global norm where the
    caller has it (a partitioned step, whose trees are one position's
    shards, sums it over the mesh); by default :func:`global_norm` of
    ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1t = 1 - cfg.b1 ** step.to(torch.float32)
    b2t = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1t
        vhat = v_new / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay (skip 1-D params: norms, biases); a
        # stacked layer leaf counts its layer axis, as in the reference
        wd = cfg.weight_decay if p.dim() > 1 else 0.0
        pf = p.to(torch.float32)
        newp = pf - lr * (delta + wd * pf)
        return newp.to(p.dtype), m_new, v_new

    # the reference zips the params' leaves with the gradients' leaves in
    # flatten order: a transform that returns a pair (grads, residuals)
    # steps on its first element, while the norm above counted both
    flat_p = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flatten(grads), flatten(state.mu), flatten(state.nu))]
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out])
                           for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step=step, mu=new_m, nu=new_v), metrics
