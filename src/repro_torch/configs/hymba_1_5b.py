"""hymba-1.5b [hybrid: parallel attention + mamba heads] (arXiv:2411.13676).

Every block mixes sliding-window GQA (25 heads, kv=5, window 1024) in
parallel with SSD heads (state N=16); the combination keeps 500k-token
decode sub-quadratic (ring-buffer KV + O(1) SSM state).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64, act="swiglu",
    parallel_ssm=True, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    sliding_window=1024,
)
