"""Architecture registry, the port of ``repro.configs``:
``get_spec("rwkv6-3b")`` / ``--arch`` ids.

Every architecture of the reference is here: the recurrent families,
``rwkv6-3b`` (K12) and ``recurrentgemma-2b`` (K11), the dense GQA family
(``qwen2-0.5b``, ``qwen2-7b``, ``gemma2-9b``, ``gemma3-4b``), the VLM
backbone ``qwen2-vl-7b`` (prefix embeddings, M-RoPE), the
encoder-decoder ``seamless-m4t-large-v2`` and the MoE family
(``mixtral-8x7b``, ``llama4-maverick-400b-a17b``).  An unknown id raises
``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch import not_ported
from repro_torch.configs.base import ArchSpec, reduced

__all__ = ["ArchSpec", "reduced", "ARCH_IDS", "get_spec"]

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "gemma3-4b": "gemma3_4b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    mod = _MODULES.get(arch_id)
    if mod is None:
        raise not_ported(f"architecture {arch_id!r} (the port has "
                         f"{sorted(_MODULES)})")
    return importlib.import_module(f"repro_torch.configs.{mod}").SPEC
