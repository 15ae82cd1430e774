"""Architecture spec plumbing, the port of ``repro.configs.base``: full
configs with their published dimensions, ``reduced()`` variants for the
CPU tests (the decoder stacks and the encoder-decoder family), and the
input shapes the launchers build steps for (``InputShape``, ``SHAPES``).
Each spec carries the reference's modality, its skipped shapes and the
number of stub prefix tokens (qwen2-vl's 256 patch embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.models.encdec import EncDecConfig


ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    citation: str
    model: Any                     # transformer.ModelConfig | EncDecConfig
    modality: str = "text"         # text | audio | vlm
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""
    n_prefix_tokens: int = 0       # vision/audio stub tokens prepended

    @property
    def is_encdec(self) -> bool:
        return isinstance(self.model, EncDecConfig)

    def runs(self, shape: str) -> bool:
        return shape not in self.skip_shapes


def reduced(spec: ArchSpec) -> ArchSpec:
    """The family-preserving smoke-test variant: the block pattern and
    feature flags kept, one pattern cycle deep (at least 2 layers, at most
    4), d_model 256 (128 for rwkv), head_dim 64, window 16, the
    long-context cap 16 where the full config has one, M-RoPE sections
    (16, 8, 8), at most 4 experts and top-2 in groups of 64 at capacity
    factor 2.0, float32; an encoder-decoder gets one layer each side at
    d_model 128; at most 16 prefix tokens."""
    m = spec.model
    if isinstance(m, EncDecConfig):
        small = dataclasses.replace(
            m, n_enc_layers=1, n_dec_layers=1, d_model=128, n_heads=4,
            n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
            dtype=torch.float32)
    else:
        moe_cfg = None
        if m.moe is not None:
            moe_cfg = dataclasses.replace(
                m.moe, n_experts=min(4, m.moe.n_experts),
                topk=min(m.moe.topk, 2), group_size=64,
                capacity_factor=2.0)
        n_layers = max(2, min(len(m.block_pattern), 4)) \
            if len(m.block_pattern) > 1 else 2
        d_model = 256 if m.block_type(0) != "rwkv" else 128
        small = dataclasses.replace(
            m, n_layers=n_layers, d_model=d_model, n_heads=4,
            n_kv_heads=max(1, min(m.n_kv_heads, 2)),
            head_dim=64, d_ff=512, vocab=512,
            window=(16 if m.window else None),
            long_context_cap=(16 if m.long_context_cap else None),
            moe=moe_cfg, dtype=torch.float32)
        if m.mrope_sections is not None:
            small = dataclasses.replace(small, mrope_sections=(16, 8, 8))
    return dataclasses.replace(spec, model=small,
                               n_prefix_tokens=min(16, spec.n_prefix_tokens))
