"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone with M-RoPE.

The language decoder is Qwen2-7B's (28 layers, d_model 3584, 28 heads GQA
kv=4, head_dim 128, d_ff 18944, vocab 152064, untied embeddings, RoPE
theta 1e6) with multimodal rotary embeddings over (temporal, height,
width) = (16, 24, 24) frequency sections.  The ViT vision encoder and its
projector are a stub, as in the reference: 256 precomputed patch
embeddings are placed before the text tokens.  long_500k is skipped (pure
full attention).
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="qwen2-vl-7b",
    family="vlm",
    modality="vlm",
    citation="arXiv:2409.12191",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; no native sub-quadratic variant",
    n_prefix_tokens=256,
    model=ModelConfig(
        name="qwen2-vl-7b",
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
        mrope_sections=(16, 24, 24),
        dtype=torch.bfloat16,
    ),
)
