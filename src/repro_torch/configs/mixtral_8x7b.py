"""Mixtral-8x7B [arXiv:2401.04088] — 8-expert top-2 MoE with SWA.

32 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), expert d_ff
14336, vocab 32000, sliding-window attention (4096) on all layers.
Runs long_500k: SWA bounds the KV cache to the window.
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="mixtral-8x7b",
    family="moe",
    citation="arXiv:2401.04088",
    model=ModelConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab=32_000,
        block_pattern=("swa",),
        window=4096,
        moe=MoEConfig(n_experts=8, topk=2, group_size=256,
                      capacity_factor=1.25),
        moe_period=1,
        tie_embeddings=False,
        rope_theta=1e6,
        dtype=torch.bfloat16,
    ),
)
