"""granite-moe-1b-a400m [MoE 32e top-8] (hf:ibm-granite)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64, act="swiglu",
    n_experts=32, experts_per_token=8, moe_d_ff=512,
    tie_embeddings=True,
)
