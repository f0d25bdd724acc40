"""Model configuration for all assigned architectures.

Counterpart of :mod:`repro.models.config`, copied: one frozen dataclass
covers the families (dense GQA, MoE, SSM, hybrid, enc-dec, VLM);
family-specific fields default to "off".  Exact per-arch values live in
``repro_torch/configs/<arch>.py``.  ``param_count`` is the reference's
formula, unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"              # swiglu | gelu | relu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # expert hidden dim (d_ff used if 0)
    dense_residual: bool = False     # arctic-style parallel dense FFN

    # SSM (mamba2 / SSD)
    ssm_state: int = 0               # N
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128             # SSD chunk Q (perf lever: the
                                     # intra-chunk decay temp is O(L·Q·H))

    # hybrid (hymba): attention and SSM heads in parallel per block
    parallel_ssm: bool = False
    sliding_window: int = 0          # 0 = full attention

    # encoder-decoder
    n_encoder_layers: int = 0

    # modality frontend (stub per brief): "vision" | "audio" | None
    frontend: Optional[str] = None
    frontend_seq: int = 0            # patches / frames per example

    # SIMDRAM PuM integration: off | sim | bitplane  (serving path)
    pum: str = "off"
    pum_bits: int = 8

    # decode-time KV-head replication up to the TP degree: keeps the
    # attention contraction fully local when n_kv_heads < TP (trades 2-4×
    # cache memory for zero per-step score collectives; §Perf lever)
    kv_head_pad: int = 0

    # MoE dispatch implementation: grouped (capacity gather/scatter under
    # GSPMD) | ep (shard_map expert parallelism, local dispatch + one
    # psum) | dense (every expert sees all tokens; tiny smoke models only)
    moe_impl: str = "grouped"

    # KV-cache storage dtype for decode: "bf16" | "int8" (per-entry-head
    # symmetric quantization; halves cache HBM traffic — §Perf lever,
    # SIMDRAM-aligned int-domain serving)
    kv_cache_dtype: str = "bf16"

    # numerics
    param_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 (TP×128-style padding, MaxText/Megatron
        convention) so the embedding shards evenly on the model axis."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode?  (SSM state or sliding win)"""
        return self.family == "ssm" or (self.parallel_ssm and self.sliding_window > 0)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (drives roofline MODEL_FLOPS = 6·N·D) ----------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        ffn_mult = 3 if self.act == "swiglu" else 2
        dense_ffn = ffn_mult * d * ff
        per_layer = 0
        if self.family == "ssm":
            di, n, p = self.d_inner, self.ssm_state, self.ssm_head_dim
            nh_ssm = self.ssm_heads
            per_layer = d * (2 * di + 2 * n + nh_ssm) + di * d \
                + self.ssm_conv * (di + 2 * n) + 2 * nh_ssm
        else:
            per_layer = attn
            if self.parallel_ssm:
                di, n = self.d_inner, self.ssm_state
                per_layer += d * (2 * di + 2 * n + self.ssm_heads) + di * d
            if self.n_experts:
                eff = self.moe_d_ff or ff
                moe = self.n_experts * ffn_mult * d * eff + d * self.n_experts
                if active_only:
                    moe = self.experts_per_token * ffn_mult * d * eff + d * self.n_experts
                per_layer += moe
                if self.dense_residual:
                    per_layer += dense_ffn
            else:
                per_layer += dense_ffn
        per_layer += 2 * d                               # norms
        total = self.n_layers * per_layer
        total += self.n_encoder_layers * (attn + dense_ffn + 3 * d)
        if self.is_encdec:
            total += self.n_layers * (attn + d)          # cross-attention
        total += v * d * (1 if self.tie_embeddings else 2)
        total += d                                        # final norm
        return int(total)


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}
