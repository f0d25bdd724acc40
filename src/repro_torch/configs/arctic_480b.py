"""arctic-480b [MoE 128e top-2 + dense residual] (hf:Snowflake).

Dense-MoE hybrid: every block has a dense FFN residual branch in
parallel with the 128-expert top-2 MoE FFN (d_ff 4864 each).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128, act="swiglu",
    n_experts=128, experts_per_token=2, moe_d_ff=4864,
    dense_residual=True,
)
