"""internvl2-1b [VLM: InternViT stub + InternLM2-ish LM] (arXiv:2404.16821).

LM backbone only; input_specs provides precomputed patch embeddings
(256 patches) which are projected and prepended to the text sequence.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64, act="swiglu",
    frontend="vision", frontend_seq=256,
)
