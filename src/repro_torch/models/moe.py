"""Mixture-of-Experts FFN with top-k routing (counterpart of
:mod:`repro.models.moe`; granite-moe, arctic).

Expert weights live in one stacked (E, ...) tensor.  ``moe_forward`` is
the dense dispatch (every expert sees every token, masked-combined);
``moe_forward_grouped`` the capacity-based gather/scatter form, whose
scatter-adds are ``index_add_``.  Aux load-balancing loss follows
Switch/GShard: E·Σ_e f_e·p_e.

``moe_forward_ep`` is the expert-parallel form over a device mesh's
``model`` axis: one program a mesh position in one process, as the
reference's ``shard_map`` runs it (see its docstring for what it
computes under a ``data`` axis).

``torch.topk`` returns the values in descending order, as
``jax.lax.top_k`` does; the two may break exact ties differently.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from ..distributed.hints import hint
from ..distributed.sharding import Sharded, data_axes
from ..launch.mesh import ambient_mesh, mark, on_stream, read_on, wait_for
from .layers import Params, gelu, normal
from .params import tree_leaves, tree_map
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
    ``ep_hints`` pins the expert buffers to ``P("model", ...)``: the
    routing, :func:`dispatch_local` and :func:`load_balance_aux`."""
    n_e = p["router"].shape[1]
    probs, topv, topi = _route(p, xt, top_k)
    out = dispatch_local(p, xt, topv, topi, act=act, cap=cap, e_lo=e_lo,
                         e_loc=e_loc, ep_hints=ep_hints)
    return out, load_balance_aux(probs, topi, n_e)


def dispatch_local(p: Params, xt: torch.Tensor, topv: torch.Tensor,
                   topi: torch.Tensor, *, act: str, cap: int, e_lo: int,
                   e_loc: int, ep_hints: bool = False) -> torch.Tensor:
    """The tokens ``xt`` (T, D), routed to ``topi`` with weights ``topv``
    (T, K), through experts [e_lo, e_lo+e_loc) of the local weights
    ``p``: the (T, D) sum of their weighted outputs.

    Tokens go to per-expert buffers of ``cap`` slots by their queue rank
    (a cumsum of one-hots); overflowed tokens land in the clamped last
    slot with their payload and weight zeroed, so they add 0, and kept
    slots are written exactly once (queue ranks are unique per expert)."""
    t, d = xt.shape
    top_k = topi.shape[-1]
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
    return out


def load_balance_aux(probs: torch.Tensor, topi: torch.Tensor,
                     n_e: int) -> torch.Tensor:
    """Switch/GShard's E·Σ_e f_e·p_e over the tokens of ``probs`` (T, E)
    and their top-k experts ``topi`` (T, K)."""
    frac_tokens = torch.mean(
        F.one_hot(topi, n_e).to(torch.float32).sum(1), dim=0)
    return n_e * torch.sum(frac_tokens * torch.mean(probs, dim=0))


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


def _at_position(w, k: int, dev: torch.device, lo: int = 0,
                hi: int = None):
    """Rows ``[lo, hi)`` of ``w`` (all of them where ``hi`` is None) for
    mesh position ``k``, on ``dev``: ``w`` a tensor, a :class:`Sharded`
    (whose shard at ``k``, where it is exactly those rows whole, is used
    as it is; else the rows are cut from the gathered tensor) or a
    quantized dict of them (``w_q`` and its scale both cut by row, as
    the reference's ``spec_like`` splits them)."""
    if isinstance(w, Mapping):
        return {name: _at_position(v, k, dev, lo, hi)
                for name, v in w.items()}
    hi = w.shape[0] if hi is None else hi
    if isinstance(w, Sharded):
        idx = w.sharding.indices(w.shape)[k]
        whole = [(s.start, s.stop) for s in idx]
        if whole == [(lo, hi)] + [(0, n) for n in w.shape[1:]]:
            return w.shards[k].to(dev)
        w = w.gather(dev)
    return w[lo:hi].to(dev)


def _shard_coords(mesh, axes, i: int) -> dict:
    """The coordinates along ``axes`` (the first major) of part ``i`` of
    a dim split over them."""
    coords = {}
    for a in reversed(axes):
        i, coords[a] = divmod(i, mesh.shape[a])
    return coords


def moe_forward_ep(
    p: Params, x: torch.Tensor, *, top_k: int, act: str,
    capacity_factor: float = 1.25, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``mesh`` (default: the ambient one), as
    the reference's ``shard_map`` over ``model`` computes it.

    Each ``model`` rank ``r`` dispatches the same tokens to its own
    ``E/tp`` experts ``[r·E/tp, (r+1)·E/tp)`` (:func:`_grouped_local`
    with those experts' weights) and the ranks' partial outputs add up
    (the psum).  The batch splits over the DATA axes where it divides,
    and each data shard dispatches alone, its capacity from its own
    tokens: under a ``data`` axis of more than one position this is not
    :func:`moe_forward_grouped` over the whole batch.  The aux loss is
    the mean over ``model`` of data shard 0's (the reference's
    ``out_specs=P()`` without a replication check returns the first
    shard's).  Falls back to :func:`moe_forward_grouped` where the
    reference does: no mesh, no ``model`` axis, or experts that do not
    divide over it.

    Data shard ``i`` at rank ``r`` runs at mesh position ``(i, r)``, on
    its device and stream (``x``'s device on an abstract mesh, where
    nothing else runs: the dry run traces it on ``meta``).  The ranks'
    partials add in rank order at the shard's first position, and the
    shards are concatenated on ``x``'s device.  Weights may be tensors,
    quantized dicts or :class:`Sharded` leaves (a position's own shard
    is used where it holds exactly its experts)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    n_e = p["router"].shape[1]
    if (mesh is None or "model" not in mesh.axis_names
            or n_e % mesh.shape["model"]):
        whole = tree_map(lambda t: t.gather(x.device)
                         if isinstance(t, Sharded) else t, p)
        return moe_forward_grouped(whole, x, top_k=top_k, act=act,
                                   capacity_factor=capacity_factor)
    b, l, d = x.shape
    tp = mesh.shape["model"]
    data = data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in data)
    n_shards = n_data if b % n_data == 0 else 1
    b_loc, e_loc = b // n_shards, n_e // tp
    cap = max(1, int(capacity_factor * b_loc * l * top_k / n_e))
    home = x.device
    names = [k for k in ("up", "gate", "down") if k in p]
    sums = []
    for i in range(n_shards):
        coords = _shard_coords(mesh, data, i) if n_shards > 1 else {}
        parts = []
        for r in range(tp):
            k = mesh.position(**coords, model=r)
            dev = mesh.device_at(k, home)
            stream = mesh.stream_at(k, dev)
            with on_stream(dev, stream):
                xs = read_on(x[i * b_loc:(i + 1) * b_loc], stream).to(dev)
                p_loc = {"router": _at_position(p["router"], k, dev)}
                for name in names:
                    p_loc[name] = _at_position(p[name], k, dev, r * e_loc,
                                               (r + 1) * e_loc)
                for t in tree_leaves(p_loc):
                    read_on(t, stream)
                out, aux = _grouped_local(
                    p_loc, xs.reshape(b_loc * l, d), top_k=top_k, act=act,
                    cap=cap, e_lo=r * e_loc, e_loc=e_loc)
                parts.append((out, aux, mark(stream)))
        # the psum over model, in rank order, at the shard's first position
        k0 = mesh.position(**coords)
        dev0 = mesh.device_at(k0, home)
        stream0 = mesh.stream_at(k0, dev0)
        with on_stream(dev0, stream0):
            out, aux = parts[0][0], parts[0][1]
            for o, a, done in parts[1:]:
                wait_for(stream0, done)
                out = out + read_on(o, stream0).to(dev0)
                aux = aux + read_on(a, stream0).to(dev0)
            sums.append((out.reshape(b_loc, l, d), aux / tp, mark(stream0)))
    cur = torch.cuda.current_stream(home) if home.type == "cuda" else None
    for o, a, done in sums:
        wait_for(cur, done)
        read_on(o, cur)
        read_on(a, cur)
    return (torch.cat([o.to(home) for o, _, _ in sums]),
            sums[0][1].to(home))
