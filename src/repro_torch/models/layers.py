"""Core NN layers (counterpart of :mod:`repro.models.layers`).

Conventions:
  - params are nested dicts of tensors under the reference's key paths;
    init_* functions build them from an explicit ``torch.Generator``, on
    its device; apply functions are plain functions on tensors.
  - layer stacks store params with a leading layer axis, as the
    reference stacks them for ``lax.scan``.
  - computations run in the params' dtype (bf16) with float32 for norms
    and softmax.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..core import bitplane

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class MetaDraws:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    has none: the init functions read its ``device``, and :func:`normal`
    gives a tensor of the shape and dtype with no values."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """Float32 normals times ``std``, cast to ``dtype``, on the device of
    ``gen`` (the reference's ``(normal(key, shape) * std).astype``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(
        dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: float = 1.0) -> Params:
    p = {"w": normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:
        # weight-only int8 (serving): dequantized in float32, then cast
        w = (p["w_q"].to(torch.float32)
             * p["scale"][..., None, :]).to(x.dtype)
    else:
        w = p["w"]
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["g"].to(torch.float32)).to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype) -> Params:
    return {"emb": normal(gen, (vocab, d), 0.02, dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["emb"][ids]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied or separate readout: x (..., d) -> logits (..., vocab)."""
    return x @ p["emb"].T


# -- rotary position embeddings ------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,L) -> cos/sin (...,L, head_dim/2), fp32."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., L, H, hd); cos/sin: (..., L, hd/2) broadcast over heads,
    cast to x's dtype before they multiply (as the reference does)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    heads = x.dim() == cos.dim() + 1
    c = (cos[..., None, :] if heads else cos).to(x.dtype)
    s = (sin[..., None, :] if heads else sin).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# -- MLPs ---------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, act: str, dtype) -> Params:
    p = {"up": dense_init(gen, d, d_ff, dtype),
         "down": dense_init(gen, d_ff, d, dtype, scale=1.0)}
    if act == "swiglu":
        p["gate"] = dense_init(gen, d, d_ff, dtype)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    return dense(p["down"], mlp_hidden(p, x, act))


def mlp_hidden(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP before its down projection."""
    up = dense(p["up"], x)
    if act == "swiglu":
        g = dense(p["gate"], x)
        return F.silu(g) * up
    if act == "gelu":
        return gelu(up)
    return F.relu(up)


def relu_stage(up: torch.Tensor, pum_bits: int = 8) -> torch.Tensor:
    """``mlp_pum``'s integer stage: ``up`` quantized to ``pum_bits``
    signed lanes, the relu as a SIMDRAM bbop on the activations' device
    (K3 on the card, the plain circuit on the CPU); int32 results of
    ``up``'s shape.  ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    scale = float(1 << (pum_bits - 2))
    q = torch.clamp(torch.round(up.to(torch.float32) * scale),
                    -(1 << (pum_bits - 1)), (1 << (pum_bits - 1)) - 1)
    flat = q.reshape(-1).to(torch.int32) & ((1 << pum_bits) - 1)
    r = bitplane.bbop("relu", pum_bits, flat, signed_out=True,
                      device=up.device)
    return r.reshape(q.shape)


def pum_relu_hidden(up: torch.Tensor, pum_bits: int = 8) -> torch.Tensor:
    """``relu(up)`` through :func:`relu_stage`: quantized, the bbop relu,
    dequantized back to ``up``'s dtype (``mlp_pum``'s hidden, and the
    partitioned MLP's on each position's ``up`` slice)."""
    scale = float(1 << (pum_bits - 2))
    r = relu_stage(up, pum_bits)
    return (r.to(torch.float32) / scale).to(up.dtype)


def mlp_pum(p: Params, x: torch.Tensor, act: str,
            pum_bits: int = 8) -> torch.Tensor:
    """MLP with the activation stage offloaded to the SIMDRAM bit-plane
    path (quantize → bbop relu → dequantize), used when cfg.pum != 'off'
    on the serving path."""
    up = dense(p["up"], x)
    if act == "swiglu":
        # silu(g)*up stays in float (not a bitwise-friendly op)
        g = dense(p["gate"], x)
        h = F.silu(g) * up
    else:
        # ReLU executes as a SIMDRAM relu bbop on int lanes
        h = pum_relu_hidden(up, pum_bits)
    return dense(p["down"], h)
