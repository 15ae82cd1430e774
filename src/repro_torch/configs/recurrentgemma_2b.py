"""RecurrentGemma-2B [arXiv:2402.19427] — hybrid RG-LRU + local attention.

26 layers, d_model 2560, 10 heads (MQA, kv=1, head_dim 256), d_ff 7680,
vocab 256000, tied and sqrt(d)-scaled embeddings, GeLU (tanh), bfloat16.
Griffin block pattern: two recurrent blocks per local (window 2048)
attention block.  The RG-LRU state is O(1) and the window bounds the KV
cache.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    citation="arXiv:2402.19427",
    model=ModelConfig(
        name="recurrentgemma-2b",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256_000,
        block_pattern=("rglru", "rglru", "swa"),
        window=2048,
        act="gelu_tanh",
        embed_scale=True,
        tie_embeddings=True,
        dtype=torch.bfloat16,
    ),
)
