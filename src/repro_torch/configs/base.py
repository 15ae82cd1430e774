"""Architecture spec plumbing, the port of ``repro.configs.base``: full
configs with their published dimensions, ``reduced()`` variants for the
CPU tests, and the input shapes the launchers build steps for
(``InputShape``, ``SHAPES``).  The encoder-decoder branch is not ported,
nor are the per-arch modality and shape skips that only the reference's
dry-run launcher reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import not_ported


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
    model: Any                     # transformer.ModelConfig


def reduced(spec: ArchSpec) -> ArchSpec:
    """The family-preserving smoke-test variant: the block pattern and
    feature flags kept, one pattern cycle deep (at least 2 layers, at most
    4), d_model 256 (128 for rwkv), head_dim 64, window 16, the
    long-context cap 16 where the full config has one, float32."""
    m = spec.model
    if m.moe is not None:
        raise not_ported("reduced MoE configs")
    n_layers = max(2, min(len(m.block_pattern), 4)) \
        if len(m.block_pattern) > 1 else 2
    d_model = 256 if m.block_type(0) != "rwkv" else 128
    small = dataclasses.replace(
        m, n_layers=n_layers, d_model=d_model, n_heads=4,
        n_kv_heads=max(1, min(m.n_kv_heads, 2)),
        head_dim=64, d_ff=512, vocab=512,
        window=(16 if m.window else None),
        long_context_cap=(16 if m.long_context_cap else None),
        dtype=torch.float32)
    return dataclasses.replace(spec, model=small)
