"""Grouped-query attention with RoPE, KV cache, sliding window, cross-attn
(counterpart of :mod:`repro.models.attention`).

Shapes: x (B, L, D); cache {"k","v"}: (B, S, n_kv, hd).  Decode calls use
L=1 queries against the full cache.

The reference's einsum form is kept: the scores are an einsum in the
params' dtype, cast to float32, scaled and masked with ``NEG_INF``; the
softmax runs in float32 and the probabilities are cast back before the
second einsum.  (``F.scaled_dot_product_attention`` rounds differently.)
The decode branch pins the fresh k/v and the written cache to the
cache's own layout with ``hint_kv`` where the reference does; the hints
change nothing on one card, and record the fitted spec under a mesh
(:mod:`repro_torch.distributed.hints`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.hints import hint_kv
from .layers import Params, apply_rope, dense, dense_init, rope_angles

NEG_INF = -1e30


def attn_init(gen, d: int, n_heads: int, n_kv: int, hd: int, dtype,
              qkv_bias: bool = False) -> Params:
    return {
        "q": dense_init(gen, d, n_heads * hd, dtype, bias=qkv_bias),
        "k": dense_init(gen, d, n_kv * hd, dtype, bias=qkv_bias),
        "v": dense_init(gen, d, n_kv * hd, dtype, bias=qkv_bias),
        "o": dense_init(gen, n_heads * hd, d, dtype),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _scale(hd: int) -> float:
    """1/sqrt(hd) rounded to float32, as the reference's
    ``1.0 / jnp.sqrt(hd).astype(jnp.float32)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _sdpa(q, k, v, mask, scale):
    """q (B,Lq,H,hd), k/v (B,Lk,G,hd) with H = G·rep (GQA)."""
    b, lq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    qg = q.reshape(b, lq, g, rep, hd)
    logits = torch.einsum("blgrh,bsgh->bgrls", qg, k).to(
        torch.float32) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrls,bsgh->blgrh", probs, v)
    return out.reshape(b, lq, h, hd)


def band_pairs(x: torch.Tensor, nb: int, w: int) -> torch.Tensor:
    """Keys or values (B, nb·w, G, d) as the banded form reads them:
    block ``i`` beside block ``i - 1`` (zeros before the first),
    (B, nb, 2w, G, d)."""
    xb = x.reshape(x.shape[0], nb, w, *x.shape[2:])
    return torch.cat([torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]],
                                dim=1), xb], dim=2)


def band_mask(nb: int, w: int, device) -> torch.Tensor:
    """Which of :func:`band_pairs`' 2w keys each query of a block sees:
    causal and within the window, and none of the zeros before the first
    block; (1, nb, 1, 1, w, 2w) against logits (B, nb, G, rep, w, 2w)."""
    t = torch.arange(w, device=device)[:, None]
    s = torch.arange(2 * w, device=device)[None, :]
    rel = t + w - s                      # key→query distance
    valid = (rel >= 0) & (rel < w)       # causal ∧ within window
    blk0 = (torch.arange(nb, device=device) == 0)[None, :, None, None, None,
                                                  None]
    return valid[None, None, None, None] & ~(
        blk0 & (s < w)[None, None, None, None])


def _banded_sdpa(q, k, v, window: int, scale):
    """Exact sliding-window attention in O(L·2W) instead of O(L²): query
    block i attends key blocks i-1 and i only."""
    b, l, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    w = window
    assert l % w == 0, (l, w)
    nb = l // w
    qb = q.reshape(b, nb, w, g, rep, hd)
    logits = torch.einsum("bnwgrh,bnsgh->bngrws", qb,
                          band_pairs(k, nb, w)).to(torch.float32) * scale
    logits = torch.where(band_mask(nb, w, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bngrws,bnsgh->bnwgrh", probs, band_pairs(v, nb, w))
    return out.reshape(b, l, h, hd)


def _q8(x: torch.Tensor):
    """int8 KV entries with symmetric per-(entry, head) scales."""
    return quantize_kv(x, torch.amax(torch.abs(x.to(torch.float32)), dim=-1))


def quantize_kv(x: torch.Tensor, amax: torch.Tensor):
    """``x`` (..., hd) as int8 entries and their float32 scales, given
    each row's max|value| ``amax`` (...): scale ``amax / 127`` (1 where
    ``amax`` is 0), entries rounded and clipped to [-127, 127]."""
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qx = torch.clamp(torch.round(x.to(torch.float32) / scale[..., None]),
                     -127, 127).to(torch.int8)
    return qx, scale


def attention(p: Params, x: torch.Tensor, positions: torch.Tensor,
              **kw) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """:func:`attention_heads` through the output projection ``p["o"]``
    (keywords as there)."""
    out, cache = attention_heads(p, x, positions, **kw)
    return dense(p["o"], out), cache


def attention_heads(
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    rope_theta: float,
    sliding_window: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    causal: bool = True,
    kv_head_pad: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention, before the output projection: the
    heads' outputs (B, L, n_heads·hd) and the cache.

    cache: decode-mode KV cache {"k","v": (B,S,G,hd)} (int8 with
      "k_scale","v_scale": (B,S,G)); the new entries are written into it
      in place at `cache_index` (ring slot for sliding window, else the
      true position), and it is returned; `positions` always carries
      TRUE positions for RoPE.
    memory: if given, cross-attention over memory (B,M,D) (no RoPE/cache).
    """
    b, l, _ = x.shape
    scale = _scale(hd)
    q = _split_heads(dense(p["q"], x), n_heads, hd)

    if memory is not None:
        k = _split_heads(dense(p["k"], memory), n_kv, hd)
        v = _split_heads(dense(p["v"], memory), n_kv, hd)
        m = torch.ones((b, l, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, m, scale)
        return out.reshape(b, l, n_heads * hd), None

    k = _split_heads(dense(p["k"], x), n_kv, hd)
    v = _split_heads(dense(p["v"], x), n_kv, hd)
    cos, sin = rope_angles(positions, hd, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        s = cache["k"].shape[1]
        idx = (cache_index if cache_index is not None else positions)[:, 0]
        if kv_head_pad > n_kv:
            # replicate kv heads consecutively, matching the grouped-query
            # head order
            rep = kv_head_pad // n_kv
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        k = hint_kv(k)
        v = hint_kv(v)
        rows = torch.arange(b, device=x.device)
        quant = cache["k"].dtype == torch.int8
        # the write slot in place: the same values as the reference's
        # where(write, new, cache) over the whole cache
        if quant:
            kq, ks = _q8(k)
            vq, vs = _q8(v)
            cache["k"][rows, idx] = kq[:, 0]
            cache["v"][rows, idx] = vq[:, 0]
            cache["k_scale"][rows, idx] = ks[:, 0]
            cache["v_scale"][rows, idx] = vs[:, 0]
            k_eff = (cache["k"].to(torch.float32)
                     * cache["k_scale"][..., None]).to(q.dtype)
            v_eff = (cache["v"].to(torch.float32)
                     * cache["v_scale"][..., None]).to(q.dtype)
        else:
            cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
            k_eff, v_eff = cache["k"], cache["v"]
        hint_kv(cache["k"])
        hint_kv(cache["v"])
        slots = torch.arange(s, device=x.device)[None, :]     # (1,S)
        cur = positions[:, 0][:, None]                       # (B,1)
        if sliding_window:
            # ring buffer of size s == sliding_window: slot age, oldest drop
            age = (idx[:, None] - slots) % s                 # 0 = just written
            valid = cur - age >= 0
        else:
            valid = slots <= cur
        mask = valid[:, None, :].expand(b, l, s)
        out = _sdpa(q, k_eff, v_eff, mask, scale)
        return out.reshape(b, l, n_heads * hd), cache

    # full-sequence (train / prefill)
    if (sliding_window and causal and l > sliding_window
            and l % sliding_window == 0):
        # banded O(L·2W) form — exact for contiguous positions
        out = _banded_sdpa(q, k, v, sliding_window, scale)
        return out.reshape(b, l, n_heads * hd), None
    qpos = positions[:, :, None]                   # (B,L,1)
    kpos = positions[:, None, :]                   # (B,1,L)
    mask = torch.ones((b, l, l), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window:
        mask = mask & (kpos > (qpos - sliding_window))
    out = _sdpa(q, k, v, mask, scale)
    return out.reshape(b, l, n_heads * hd), None


def init_cache(b: int, s: int, n_kv: int, hd: int, dtype, device,
               quantized: bool = False) -> Dict[str, torch.Tensor]:
    if quantized:
        return {
            "k": torch.zeros((b, s, n_kv, hd), dtype=torch.int8,
                             device=device),
            "v": torch.zeros((b, s, n_kv, hd), dtype=torch.int8,
                             device=device),
            "k_scale": torch.ones((b, s, n_kv), dtype=torch.float32,
                                  device=device),
            "v_scale": torch.ones((b, s, n_kv), dtype=torch.float32,
                                  device=device),
        }
    return {
        "k": torch.zeros((b, s, n_kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((b, s, n_kv, hd), dtype=dtype, device=device),
    }
