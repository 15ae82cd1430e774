"""Qwen2-7B [arXiv:2407.10671] — dense GQA with QKV bias.

28 layers, d_model 3584, 28 heads (GQA kv=4, head_dim 128), d_ff 18944,
vocab 152064, untied embeddings, RoPE theta 1e6, bfloat16.  Pure full
attention: the KV cache grows with the context.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="qwen2-7b",
    family="dense",
    citation="arXiv:2407.10671",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; no native sub-quadratic variant",
    model=ModelConfig(
        name="qwen2-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18_944,
        vocab=152_064,
        qkv_bias=True,
        tie_embeddings=False,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    ),
)
