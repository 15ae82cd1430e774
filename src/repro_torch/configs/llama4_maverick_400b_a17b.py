"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] —
128-expert top-1 MoE with a shared expert, interleaved dense/MoE layers,
chunked local attention (3 local : 1 global, iRoPE-style).

48 layers, d_model 5120, 40 heads (GQA kv=8, head_dim 128), expert d_ff
8192, vocab 202048.  ~400B total / ~17B active parameters.
Runs long_500k with the global layers capped to an 8192 window
(long-context mode, a documented deviation of the reference).
"""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

SPEC = ArchSpec(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    model=ModelConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202_048,
        block_pattern=("swa", "swa", "swa", "attn"),
        window=8192,
        long_context_cap=8192,
        moe=MoEConfig(n_experts=128, topk=1, group_size=256,
                      capacity_factor=1.25),
        moe_period=2,              # interleaved dense/MoE (Maverick)
        n_shared_experts=1,
        tie_embeddings=False,
        rope_theta=5e5,
        dtype=torch.bfloat16,
    ),
)
