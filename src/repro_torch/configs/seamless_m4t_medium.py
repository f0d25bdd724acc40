"""seamless-m4t-medium [audio enc-dec] (arXiv:2308.11596; hf).

Transformer backbone only — the speech frontend is a stub providing
precomputed frame embeddings (frames = seq_len // 4 in input_specs).
12 encoder + 12 decoder layers, MHA (kv=16), d_ff 4096, vocab 256206.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    n_encoder_layers=12, act="gelu", tie_embeddings=True,
    frontend="audio", frontend_seq=1024,
)
