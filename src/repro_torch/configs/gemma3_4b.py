"""Gemma-3 4B [hf:google/gemma-3-1b-pt family] — 5:1 local:global
attention, QK-norm.

34 layers, d_model 2560, 8 heads (GQA kv=4, head_dim 256), d_ff 10240,
vocab 262144, local window 1024, tied and sqrt(d)-scaled embeddings, GeLU
(tanh), RoPE theta 1e6, bfloat16.  The global layers carry the
reference's long-context cap of 8192 (its serve path keeps it).
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="gemma3-4b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    model=ModelConfig(
        name="gemma3-4b",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10_240,
        vocab=262_144,
        block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=1024,
        long_context_cap=8192,
        qk_norm=True,
        act="gelu_tanh",
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    ),
)
