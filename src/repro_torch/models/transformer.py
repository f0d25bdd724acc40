"""Model assembly for every assigned architecture family (counterpart of
:mod:`repro.models.transformer`).

A model = embeddings + a stack of homogeneous blocks + final norm
(+ optional encoder stack for enc-dec, + modality-stub inputs for VLM /
audio).  Layer params are stacked on a leading axis, as in the
reference; where it runs ``lax.scan`` over that axis, the port loops
over it (``unroll`` is accepted and changes nothing).  ``remat`` is the
reference's rematerialization policy for a block when a backward will
run: ``"full"`` checkpoints each block, ``"dots"`` saves only its
unbatched weight products (``aten.mm``/``addmm``, what
``dots_with_no_batch_dims_saveable`` saves) and recomputes the rest,
attention's batched einsums included; anything else saves everything.

Families:
  dense   : GQA attention + (Sw)GLU MLP            (granite/yi/qwen/phi3)
  moe     : GQA attention + top-k MoE (+ optional dense residual) (granite-moe/arctic)
  ssm     : Mamba-2 SSD mixer only                  (mamba2)
  hybrid  : parallel attention ⊕ SSD heads + MLP    (hymba)
  encdec  : bidirectional encoder + causal decoder w/ cross-attn (seamless)
  vlm     : dense decoder over [vision-stub ++ text] (internvl2)
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.build import resolve_device
from .attention import attention, attn_init, init_cache
from .config import ModelConfig
from .layers import (Params, _dtype, dense, dense_init, embed, embedding_init,
                     mlp, mlp_init, mlp_pum, rmsnorm, rmsnorm_init, unembed)
from .moe import moe_forward, moe_forward_ep, moe_forward_grouped, moe_init
from .params import layer, tree_leaves, tree_map, unstack
from .ssm import init_ssm_cache, ssm_forward, ssm_init


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig,
               cross_attn: bool = False, causal: bool = True) -> Params:
    dt = _dtype(cfg.param_dtype)
    dev = gen.device
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dt, dev)}
    if cfg.family != "ssm":
        p["attn"] = attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, dt, cfg.qkv_bias)
    if cfg.family == "ssm" or cfg.parallel_ssm:
        p["ssm"] = ssm_init(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                            cfg.ssm_heads, cfg.ssm_conv, dt)
    if cross_attn:
        p["ln_x"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["xattn"] = attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, dt, cfg.qkv_bias)
    if cfg.family != "ssm":
        p["ln2"] = rmsnorm_init(cfg.d_model, dt, dev)
        if cfg.n_experts:
            p["moe"] = moe_init(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                cfg.n_experts, cfg.act, dt)
            if cfg.dense_residual:
                p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt)
    return p


def block_forward(
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict] = None,
    cache_index: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    causal: bool = True,
    moe_grouped: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    mixed = torch.zeros_like(x)
    new_cache: Dict = {}

    if "attn" in p:
        a_out, a_cache = attention(
            p["attn"], h, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
            cache=None if cache is None else cache.get("attn"),
            cache_index=cache_index,
            causal=causal,
            kv_head_pad=cfg.kv_head_pad,
        )
        mixed = mixed + a_out
        if a_cache is not None:
            new_cache["attn"] = a_cache
    if "ssm" in p:
        s_out, s_cache = ssm_forward(
            p["ssm"], h, cfg, cache=None if cache is None else cache.get("ssm"))
        mixed = mixed + s_out
        if s_cache is not None:
            new_cache["ssm"] = s_cache
    x = x + mixed

    if "xattn" in p and memory is not None:
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x_out, _ = attention(
            p["xattn"], hx, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta, memory=memory)
        x = x + x_out

    if "ln2" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        ff = torch.zeros_like(x)
        if "moe" in p:
            fwd = {"grouped": moe_forward_grouped, "ep": moe_forward_ep,
                   "dense": moe_forward}[cfg.moe_impl if moe_grouped
                                         else "dense"]
            m_out, m_aux = fwd(p["moe"], h2, top_k=cfg.experts_per_token,
                               act=cfg.act)
            ff = ff + m_out
            aux = aux + m_aux
        if "mlp" in p:
            if cfg.pum != "off" and cfg.act == "relu":
                ff = ff + mlp_pum(p["mlp"], h2, cfg.act, cfg.pum_bits)
            else:
                ff = ff + mlp(p["mlp"], h2, cfg.act)
        x = x + ff
    return x, (new_cache or None), aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _stacked(n: int, make) -> Params:
    """``n`` draws of ``make()`` stacked on a leading axis, filled layer
    by layer (the reference's ``vmap`` of an init over layer keys)."""
    first = make()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    for i in range(n):
        tree_map(lambda o, t: o[i].copy_(t), out, first if i == 0 else make())
    return out


def init_lm(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
            device="cuda") -> Params:
    """Random init on ``device``, drawn from ``generator`` (default: a
    fresh generator on ``device`` seeded with 0): the reference's
    distributions, shapes and dtypes, not its ``jax.random`` draws."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the model on "
                         f"{dev}")
    dt = _dtype(cfg.param_dtype)
    p: Params = {"embed": embedding_init(gen, cfg.vocab_padded, cfg.d_model,
                                         dt)}
    p["blocks"] = _stacked(
        cfg.n_layers, lambda: init_block(gen, cfg, cross_attn=cfg.is_encdec))
    p["ln_f"] = rmsnorm_init(cfg.d_model, dt, dev)
    if cfg.is_encdec:
        p["enc_blocks"] = _stacked(
            cfg.n_encoder_layers,
            lambda: init_block(gen, cfg, cross_attn=False, causal=False))
        p["enc_ln_f"] = rmsnorm_init(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dt)
    if cfg.frontend:
        # modality stub: a single projection standing in for ViT/audio-enc
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dt)
    return p


def _n_layers(blocks: Params) -> int:
    return next(tree_leaves(blocks)).shape[0]


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _scan_blocks(blocks: Params, x, positions, cfg, *, memory=None,
                 causal=True, remat: str = "dots"):
    """The block stack over the full sequence (train/prefill; no cache):
    a loop over the layers of the stacked tree, each block under
    ``remat`` when autograd records."""

    def body(h, lp):
        h, _, a = block_forward(lp, h, positions, cfg, memory=memory,
                                causal=causal)
        return h, a

    if torch.is_grad_enabled() and remat == "full":
        body = functools.partial(checkpoint, body, use_reentrant=False)
    elif torch.is_grad_enabled() and remat == "dots":
        body = functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_products))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack(blocks):
        x, a = body(x, lp)
        aux = aux + a
    return x, aux


def lm_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    encoder_feats: Optional[torch.Tensor] = None,   # (B, F, D) audio/enc stub
    vision_embeds: Optional[torch.Tensor] = None,   # (B, P, D) vision stub
    remat: str = "dots",
    unroll: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward: tokens (B,L) -> logits (B,L,V), aux loss."""
    b, l = tokens.shape
    dev = tokens.device
    x = embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(l, dtype=torch.int32,
                                 device=dev)[None].expand(b, l)

    memory = None
    if cfg.is_encdec:
        assert encoder_feats is not None, "enc-dec needs encoder features"
        ef = (dense(params["frontend_proj"], encoder_feats) if cfg.frontend
              else encoder_feats)
        fpos = torch.arange(ef.shape[1], dtype=torch.int32,
                            device=dev)[None].expand(*ef.shape[:2])
        memory, _ = _scan_blocks(params["enc_blocks"], ef, fpos, cfg,
                                 causal=False, remat=remat)
        memory = rmsnorm(params["enc_ln_f"], memory, cfg.norm_eps)

    if vision_embeds is not None:
        ve = dense(params["frontend_proj"], vision_embeds)
        x = torch.cat([ve.to(x.dtype), x], dim=1)
        vp = ve.shape[1]
        positions = torch.cat(
            [torch.arange(vp, dtype=torch.int32, device=dev)[None].expand(
                b, vp), positions + vp], dim=1)

    x, aux = _scan_blocks(params["blocks"], x, positions, cfg, memory=memory,
                          remat=remat)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if vision_embeds is not None:
        x = x[:, vision_embeds.shape[1]:, :]
    logits = (unembed(params["embed"], x) if cfg.tie_embeddings
              else dense(params["out"], x))
    return logits, aux


# ---------------------------------------------------------------------------
# decode path (explicit caches, loop over layers)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, b: int, s: int, device="cuda") -> Dict:
    """Stacked per-layer caches (leading layer axis) for decode, on
    ``device``."""
    dev = resolve_device(device)
    dt = _dtype(cfg.param_dtype)
    one: Dict = {}
    if cfg.family != "ssm":
        kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
        g = max(cfg.n_kv_heads, cfg.kv_head_pad)
        one["attn"] = init_cache(b, kv_len, g, cfg.hd, dt, dev,
                                 quantized=cfg.kv_cache_dtype == "int8")
    if cfg.family == "ssm" or cfg.parallel_ssm:
        one["ssm"] = init_ssm_cache(b, cfg, dt, dev)
    return tree_map(lambda t: t[None].repeat(cfg.n_layers, *([1] * t.dim())),
                    one)


def decode_step(
    params: Params,
    caches: Dict,
    token: torch.Tensor,     # (B,) current token ids
    pos: torch.Tensor,       # (B,) positions
    cfg: ModelConfig,
    *,
    memory: Optional[torch.Tensor] = None,
    unroll: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step: returns (logits (B,V), caches).  Each layer's
    slice of the stacked caches is written in place, and the caches are
    returned (the reference returns new ones)."""
    x = embed(params["embed"], token)[:, None, :]        # (B,1,D)
    positions = pos[:, None]
    if cfg.sliding_window:
        # ring-buffer write slot within the window (RoPE still uses true pos)
        cache_idx = (pos % cfg.sliding_window)[:, None]
    else:
        cache_idx = positions

    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        lcache = layer(caches, i)
        x, new_cache, _ = block_forward(
            layer(blocks, i), x, positions, cfg, cache=lcache,
            cache_index=cache_idx, memory=memory)
        # attention writes its cache slice in place; the SSM returns new
        # state tensors, copied into the slice
        tree_map(lambda old, new: None if new is old else old.copy_(new),
                 lcache, new_cache)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = (unembed(params["embed"], x) if cfg.tie_embeddings
              else dense(params["out"], x))
    return logits[:, 0, :], caches
