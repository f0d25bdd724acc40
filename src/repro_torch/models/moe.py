"""Mixture-of-Experts FFN with top-k routing (counterpart of
:mod:`repro.models.moe`; granite-moe, arctic).

Expert weights live in one stacked (E, ...) tensor.  ``moe_forward`` is
the dense dispatch (every expert sees every token, masked-combined);
``moe_forward_grouped`` the capacity-based gather/scatter form, whose
scatter-adds are ``index_add_``.  Aux load-balancing loss follows
Switch/GShard: E·Σ_e f_e·p_e.

``torch.topk`` returns the values in descending order, as
``jax.lax.top_k`` does; the two may break exact ties differently.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.hints import hint
from ..launch.mesh import ambient_mesh
from .layers import Params, gelu, normal
from .quantized import effective_weight


def moe_init(gen, d: int, d_ff: int, n_experts: int, act: str,
             dtype) -> Params:
    std = 1.0 / math.sqrt(d)
    p = {
        "router": normal(gen, (d, n_experts), std, torch.float32),
        "up": normal(gen, (n_experts, d, d_ff), std, dtype),
        "down": normal(gen, (n_experts, d_ff, d), 1.0 / math.sqrt(d_ff),
                       dtype),
    }
    if act == "swiglu":
        p["gate"] = normal(gen, (n_experts, d, d_ff), std, dtype)
    return p


def _route(p: Params, x: torch.Tensor, top_k: int):
    """Router probabilities (..., E) in float32 and the renormalized top-k
    (values, expert indices)."""
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def _act(up, gate, act: str):
    return F.silu(gate) * up if act == "swiglu" else gelu(up)


def moe_forward(p: Params, x: torch.Tensor, *, top_k: int,
                act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,D) -> (out (B,L,D), aux_loss ())."""
    n_e = p["router"].shape[1]
    probs, topv, topi = _route(p, x, top_k)                 # (B,L,K)

    # combine weights (B,L,E): scatter top-k renormalized probs
    onehot = F.one_hot(topi, n_e).to(torch.float32)          # (B,L,K,E)
    comb = torch.einsum("blk,blke->ble", topv, onehot)

    # dense dispatch: every expert sees all tokens, masked-combined
    up = torch.einsum("bld,edf->blef", x, effective_weight(p["up"], x.dtype))
    g = (torch.einsum("bld,edf->blef", x,
                      effective_weight(p["gate"], x.dtype))
         if act == "swiglu" else None)
    h = _act(up, g, act)
    out = torch.einsum("blef,efd->bled", h,
                       effective_weight(p["down"], x.dtype))
    out = torch.einsum("bled,ble->bld", out, comb.to(out.dtype))

    frac_tokens = torch.mean(onehot.sum(2), dim=(0, 1))     # f_e
    frac_probs = torch.mean(probs, dim=(0, 1))               # p_e
    aux = n_e * torch.sum(frac_tokens * frac_probs)
    return out, aux


def _grouped_local(p: Params, xt: torch.Tensor, *, top_k: int, act: str,
                   cap: int, e_lo: int, e_loc: int, ep_hints: bool = False):
    """Token dispatch restricted to experts [e_lo, e_lo+e_loc) with local
    expert weights ``p``; tokens routed elsewhere contribute zero.
    ``ep_hints`` pins the expert buffers to ``P("model", ...)``.

    Tokens go to per-expert buffers of ``cap`` slots by their queue rank
    (a cumsum of one-hots); overflowed tokens land in the clamped last
    slot with their payload and weight zeroed, so they add 0, and kept
    slots are written exactly once (queue ranks are unique per expert)."""
    t, d = xt.shape
    n_e = p["router"].shape[1]
    probs, topv, topi = _route(p, xt, top_k)

    flat_e = topi.reshape(-1)                                  # (T*K,)
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    local_e = torch.clamp(flat_e - e_lo, 0, e_loc - 1)
    onehot = F.one_hot(local_e, e_loc).to(torch.int32) * mine[:, None]
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # queue rank
    keep = mine & (pos < cap)
    slot = torch.where(keep, pos, cap - 1)                     # clamp overflow
    buf_idx = local_e * cap + slot
    tok_idx = torch.arange(t, device=xt.device).repeat_interleave(top_k)

    payload = xt[tok_idx] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((e_loc * cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, buf_idx, payload)
    eb = buf.reshape(e_loc, cap, d)
    if ep_hints:
        eb = hint(eb, "model", None, None)

    up = torch.einsum("ecd,edf->ecf", eb, effective_weight(p["up"], eb.dtype))
    g = (torch.einsum("ecd,edf->ecf", eb,
                      effective_weight(p["gate"], eb.dtype))
         if act == "swiglu" else None)
    h = _act(up, g, act)
    eout = torch.einsum("ecf,efd->ecd", h, effective_weight(
        p["down"], eb.dtype))
    if ep_hints:
        eout = hint(eout, "model", None, None)
    eout = eout.reshape(e_loc * cap, d)

    w = (topv.reshape(-1) * keep).to(eout.dtype)
    out = torch.zeros((t, d), dtype=eout.dtype, device=xt.device)
    out.index_add_(0, tok_idx, eout[buf_idx] * w[:, None])

    frac_tokens = torch.mean(
        F.one_hot(topi, n_e).to(torch.float32).sum(1), dim=0)
    aux = n_e * torch.sum(frac_tokens * torch.mean(probs, dim=0))
    return out, aux


def moe_forward_grouped(
    p: Params, x: torch.Tensor, *, top_k: int, act: str,
    capacity_factor: float = 1.25, ep_hints: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch: per-expert buffers of C = cf·T·K/E slots.
    This is :func:`_grouped_local` over every expert (with all experts
    local, its ``mine`` mask is all true and the two compute the same).
    ``ep_hints`` pins the buffers' layout under a device mesh; on one
    card it changes nothing."""
    b, l, d = x.shape
    t = b * l
    n_e = p["router"].shape[1]
    cap = max(1, int(capacity_factor * t * top_k / n_e))
    out, aux = _grouped_local(p, x.reshape(t, d), top_k=top_k, act=act,
                              cap=cap, e_lo=0, e_loc=n_e,
                              ep_hints=ep_hints)
    return out.reshape(b, l, d), aux


def moe_forward_ep(
    p: Params, x: torch.Tensor, *, top_k: int, act: str,
    capacity_factor: float = 1.25, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over a device mesh's ``model`` axis.  The port
    runs on one card: where the reference falls back to
    :func:`moe_forward_grouped` (no ambient mesh with a ``model`` axis,
    or experts that do not divide over it) so does this, and on a
    ``model`` axis of one device the two compute the same; a mesh given
    as ``mesh``, or an ambient one that would split the experts, raises."""
    ambient = ambient_mesh()
    n_e = p["router"].shape[1]
    tp = (ambient.shape["model"]
          if ambient is not None and "model" in ambient.axis_names else 1)
    if mesh is not None or (tp > 1 and n_e % tp == 0):
        raise ValueError(
            "moe_forward_ep: a device mesh was given, but expert parallelism "
            "across devices is not ported; the port runs on one card")
    return moe_forward_grouped(p, x, top_k=top_k, act=act,
                               capacity_factor=capacity_factor)
