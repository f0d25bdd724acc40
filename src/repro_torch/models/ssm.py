"""Mamba-2 SSD (state-space duality) layer, chunked and sub-quadratic
(counterpart of :mod:`repro.models.ssm`).

Scalar-per-head decay A, multi-head state (N×P per head), causal
depthwise conv on (x,B,C), gated RMSNorm output.  Prefill uses the
chunked form (intra-chunk dual "attention" + an inter-chunk state
recurrence, a short loop over chunks); decode carries an explicit
(B,H,N,P) state, O(1) per token.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Params, dense, dense_init, normal, rmsnorm, rmsnorm_init


def ssm_init(gen, d: int, d_inner: int, n_state: int, n_heads: int,
             conv_k: int, dtype) -> Params:
    # three separate projections (z / xBC / dt), as the reference
    conv_dim = d_inner + 2 * n_state
    dev = gen.device
    return {
        "in_proj_z": dense_init(gen, d, d_inner, dtype),
        "in_proj_xbc": dense_init(gen, d, conv_dim, dtype),
        "in_proj_dt": dense_init(gen, d, n_heads, dtype),
        "conv_w": normal(gen, (conv_k, conv_dim), 0.2, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "a_log": torch.zeros(n_heads, dtype=torch.float32, device=dev),
        "d_skip": torch.ones(n_heads, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(n_heads, dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along L as the reference writes it, a sum of
    shifted products (``F.conv1d`` runs in TF32 on the card).  x (B,L,C),
    w (K,C).  Returns (y, new_state); the state carries the last K-1
    inputs for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                  # (B, L+K-1, C)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    y = y + b[None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(y), new_state


def ssd_chunked(xh, bmat, cmat, dt, a_log, chunk: int):
    """Chunked SSD scan.

    xh (B,L,H,P), bmat/cmat (B,L,N), dt (B,L,H) [post-softplus], a_log (H,)
    -> (y (B,L,H,P), last state (B,H,N,P) float32)
    """
    bsz, l, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    assert l % q == 0, (l, q)
    nc = l // q

    dta = (dt * (-torch.exp(a_log))[None, None, :]).to(torch.float32)
    xw = xh * dt[..., None].to(xh.dtype)                  # dt-weighted input

    def ch(t):
        return t.reshape(bsz, nc, q, *t.shape[2:])
    xc, bc, cc, lc = ch(xw), ch(bmat), ch(cmat), ch(dta)
    cum = torch.cumsum(lc, dim=2)                         # (B,NC,Q,H)

    # intra-chunk: score[t,τ] = C_t·B_τ · exp(cum_t - cum_τ) for τ ≤ t
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)          # (B,NC,Q,Q)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,NC,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(rel),
                        0.0).to(xc.dtype)
    w = cb[..., None].to(xc.dtype) * decay                # (B,NC,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w.to(xc.dtype), xc)

    # chunk summary states: Σ_τ exp(cum_end - cum_τ)·B_τ ⊗ x_τ
    tail = torch.exp(cum[:, :, -1:, :] - cum)             # (B,NC,Q,H)
    s_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bc, tail.to(bc.dtype),
                           xc)

    # inter-chunk recurrence over chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,NC,H)
    s32 = s_chunk.to(torch.float32)
    h_state = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                          device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, c, :, None, None] + s32[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,NC,H,N,P)

    # inter-chunk output: C_t · (exp(cum_t) ⊙ h_prev_chunk)
    y_inter = torch.einsum(
        "bcqn,bcqh,bchnp->bcqhp",
        cc, torch.exp(cum).to(cc.dtype), h_prevs.to(cc.dtype))
    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y, h_state


def ssm_forward(
    p: Params,
    x: torch.Tensor,
    cfg,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba-2 mixer.  x (B,L,D) -> (B,L,D).

    cache (decode): {"conv": (B,K-1,conv_dim), "ssm": (B,H,N,P)}; the new
    cache is returned.
    """
    d_inner, n, h, pdim = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                           cfg.ssm_head_dim)
    chunk = chunk or getattr(cfg, "ssm_chunk", 128)
    bsz, l, _ = x.shape
    z = dense(p["in_proj_z"], x)
    xbc = dense(p["in_proj_xbc"], x)
    dt = dense(p["in_proj_dt"], x)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    xh = xs.reshape(bsz, l, h, pdim)

    if cache is not None:
        # single-token recurrence
        dec = torch.exp(dt * (-torch.exp(p["a_log"]))[None, None, :])
        db_x = torch.einsum("bln,blh,blhp->bhnp", bmat, dt.to(bmat.dtype), xh)
        h_new = (cache["ssm"] * dec[:, 0, :, None, None]
                 + db_x.to(torch.float32))
        y = torch.einsum("bln,bhnp->blhp", cmat, h_new.to(cmat.dtype))
        new_cache = {"conv": new_conv, "ssm": h_new}
    else:
        y, _ = ssd_chunked(xh, bmat, cmat, dt, p["a_log"], chunk)
        new_cache = None

    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(bsz, l, d_inner)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return dense(p["out_proj"], y), new_cache


def init_ssm_cache(b: int, cfg, dtype, device) -> Dict[str, torch.Tensor]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((b, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((b, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }
