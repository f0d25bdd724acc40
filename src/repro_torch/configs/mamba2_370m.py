"""mamba2-370m [SSM, attention-free] (arXiv:2405.21060).

SSD: d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads, state N=128.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, ssm_conv=4, tie_embeddings=True,
)
