"""Weight-only int8 quantization for serving (counterpart of
:mod:`repro.models.quantized`).

``quantize_tree(params)`` rewrites every dense weight dict {"w": (...,K,N)}
into {"w_q": int8, "scale": (...,N) float32} (symmetric per output
channel) and every stacked MoE weight likewise, in a new tree that
shares the other tensors.  ``layers.dense`` and the MoE einsums dispatch
on the presence of "w_q", so the same model code runs either tree.
Embeddings and norms stay in the params' dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    wf = w.to(torch.float32)
    amax = torch.amax(torch.abs(wf), dim=-2)                    # (..., N)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(
        torch.int8)
    return {"w_q": q, "scale": scale}


def dequantize_weight(p: Dict[str, torch.Tensor],
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (p["w_q"].to(torch.float32) * p["scale"][..., None, :]).to(dtype)


def quantize_tree(params: Any) -> Any:
    """Quantize every dense-weight leaf dict in a param tree."""

    def walk(node):
        if isinstance(node, dict):
            new = {}
            for k, v in node.items():
                if k == "w" and torch.is_tensor(v) and v.dim() >= 2:
                    new.update(_quantize_weight(v))
                elif (k in ("up", "gate", "down") and torch.is_tensor(v)
                      and v.dim() >= 3):
                    # stacked MoE expert weights (L,E,K,N)
                    new[k] = _quantize_weight(v)
                else:
                    new[k] = walk(v)
            return new
        return node

    return walk(params)


def effective_weight(p_or_w, dtype=torch.bfloat16) -> torch.Tensor:
    """Accept either a raw tensor or a quantized dict."""
    if isinstance(p_or_w, dict) and "w_q" in p_or_w:
        return dequantize_weight(p_or_w, dtype)
    return p_or_w
