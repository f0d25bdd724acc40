"""Training step: loss, microbatch gradient accumulation, remat
(counterpart of :mod:`repro.train.train_loop`).

``make_train_step(cfg, ...)`` builds the step function
(params, opt_state, batch) -> (params, opt_state, metrics) over param
trees of tensors and a batch of tensors on the params' device.
Gradients come from ``torch.autograd.grad`` over the tree's leaves
(detached, set to require grad inside the step); a leaf the loss does
not reach (the PuM MLP's ``up``, cut by its integer stage) gets a zero
gradient, as ``jax.grad`` gives it, so weight decay and the moments'
decay still apply to it.  Microbatches are contiguous slices of the
batch's leading axis, run one after another with their gradients summed
in fp32 (peak activation memory is one microbatch's).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import _dtype
from ..models.params import flatten, tree_map, unflatten
from ..models.transformer import lm_forward
from . import optimizer as opt


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token loss (labels == -1 masked) + z-loss, fp32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(
        lf, torch.clamp(labels, min=0).long()[..., None], dim=-1)[..., 0]
    nll = lse - gold
    mask = (labels >= 0).to(torch.float32)
    nll = nll * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll.sum() + zl.sum()) / denom, denom


def make_loss_fn(cfg: ModelConfig, remat: str = "dots", unroll: bool = False):
    dt = _dtype(cfg.param_dtype)

    def loss_fn(params, batch):
        # the reference casts the stub features to bf16 and lets the
        # first product promote them to the params' dtype
        kw = {}
        if cfg.is_encdec:
            kw["encoder_feats"] = batch["encoder_feats"].to(
                torch.bfloat16).to(dt)
        if cfg.family == "vlm":
            kw["vision_embeds"] = batch["vision_embeds"].to(
                torch.bfloat16).to(dt)
        logits, aux = lm_forward(params, batch["tokens"], cfg,
                                 remat=remat, unroll=unroll, **kw)
        if cfg.vocab_padded != cfg.vocab_size:
            # mask padding vocab entries out of the softmax
            real = torch.arange(logits.shape[-1],
                                device=logits.device) < cfg.vocab_size
            logits = torch.where(real, logits, -1e30)
        loss, denom = softmax_xent(logits, batch["labels"])
        moe_w = 0.01 if cfg.n_experts else 0.0
        return loss + moe_w * aux, {"loss": loss, "aux": aux}

    return loss_fn


def make_train_step(
    cfg: ModelConfig,
    ocfg: opt.AdamWConfig,
    *,
    n_microbatches: int = 1,
    remat: str = "dots",
    unroll: bool = False,
    grad_transform: Optional[Callable[[Any], Any]] = None,
):
    """Build the train step.

    grad_transform: optional hook applied to the summed gradients before
    the optimizer — e.g. straggler-mitigation scaling from
    fault_tolerance.
    """
    loss_fn = make_loss_fn(cfg, remat, unroll)

    def value_and_grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        total, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(total, flatten(live),
                                    materialize_grads=True)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten(live, grads))

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            _, metrics, grads = value_and_grad(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, auxes = [], []
            for i in range(n_microbatches):
                mb = {k: x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                                   *x.shape[1:])[i] for k, x in batch.items()}
                loss, m, g = value_and_grad(params, mb)
                tree_map(torch.Tensor.add_, grads, g)
                losses.append(loss)
                auxes.append(m["aux"])
            grads = tree_map(lambda g: g / n_microbatches, grads)
            metrics = {"loss": torch.stack(losses).mean(),
                       "aux": torch.stack(auxes).mean()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, om = opt.update(ocfg, params, grads, opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
