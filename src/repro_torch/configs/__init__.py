"""Assigned-architecture registry (counterpart of :mod:`repro.configs`,
with the published values unchanged)."""

from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig, SHAPES, SHAPES_BY_NAME, ShapeSpec

from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .granite_3_8b import CONFIG as granite_3_8b
from .yi_6b import CONFIG as yi_6b
from .qwen2_72b import CONFIG as qwen2_72b
from .phi3_medium_14b import CONFIG as phi3_medium_14b
from .mamba2_370m import CONFIG as mamba2_370m
from .granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from .arctic_480b import CONFIG as arctic_480b
from .hymba_1_5b import CONFIG as hymba_1_5b
from .internvl2_1b import CONFIG as internvl2_1b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        seamless_m4t_medium, granite_3_8b, yi_6b, qwen2_72b, phi3_medium_14b,
        mamba2_370m, granite_moe_1b_a400m, arctic_480b, hymba_1_5b,
        internvl2_1b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    c = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(c.n_kv_heads, 2)), d_ff=128, vocab_size=256,
        head_dim=16,
    )
    if c.n_experts:
        kw.update(n_experts=4, experts_per_token=min(2, c.experts_per_token),
                  moe_d_ff=32)
    if c.family == "ssm" or c.parallel_ssm:
        kw.update(ssm_state=8, ssm_head_dim=16)
    if c.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if c.sliding_window:
        kw.update(sliding_window=16)
    if c.frontend:
        kw.update(frontend_seq=8)
    return c.replace(**kw)


# cells skipped per DESIGN.md §Arch-applicability (long_500k needs
# sub-quadratic sequence mixing; enc-dec/VLM decode uses its decoder = ok)
def cell_is_supported(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
