"""Qwen2-0.5B [arXiv:2407.10671] — dense GQA with QKV bias.

24 layers, d_model 896, 14 heads (GQA kv=2, head_dim 64), d_ff 4864,
vocab 151936, tied embeddings, RoPE theta 1e6, bfloat16.  Pure full
attention: the KV cache grows with the context.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="qwen2-0.5b",
    family="dense",
    citation="arXiv:2407.10671",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; no native sub-quadratic variant",
    model=ModelConfig(
        name="qwen2-0.5b",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151_936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    ),
)
