"""Gemma-2 9B [arXiv:2408.00118] — alternating local/global attention with
logit soft-capping and sandwich (post) norms.

42 layers, d_model 3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336,
vocab 256000, local window 4096, attn softcap 50, final softcap 30, tied
and sqrt(d)-scaled embeddings, GeLU (tanh), bfloat16.  The global layers
carry the reference's long-context cap of 8192 (its serve path keeps it).
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="gemma2-9b",
    family="dense",
    citation="arXiv:2408.00118",
    model=ModelConfig(
        name="gemma2-9b",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14_336,
        vocab=256_000,
        block_pattern=("swa", "attn"),
        window=4096,
        long_context_cap=8192,
        softcap_attn=50.0,
        softcap_final=30.0,
        post_norm=True,
        act="gelu_tanh",
        embed_scale=True,
        tie_embeddings=True,
        dtype=torch.bfloat16,
    ),
)
