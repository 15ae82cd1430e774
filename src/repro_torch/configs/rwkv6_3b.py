"""RWKV6-3B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

32 layers, d_model 2560 (40 heads of 64), d_ff 8960, vocab 65536, untied
embeddings, bfloat16.  The recurrence state is O(1) in context length.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="rwkv6-3b",
    family="ssm",
    citation="arXiv:2404.05892",
    model=ModelConfig(
        name="rwkv6-3b",
        n_layers=32,
        d_model=2560,
        n_heads=40,            # informational; rwkv uses 64-dim heads
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab=65_536,
        block_pattern=("rwkv",),
        tie_embeddings=False,
        dtype=torch.bfloat16,
    ),
)
