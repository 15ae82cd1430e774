"""Architecture registry, the port of ``repro.configs``:
``get_spec("rwkv6-3b")`` / ``--arch`` ids.

The port serves the recurrent families, ``rwkv6-3b`` (K12) and
``recurrentgemma-2b`` (K11), and the dense GQA family: ``qwen2-0.5b``,
``qwen2-7b``, ``gemma2-9b`` and ``gemma3-4b``.  Every other architecture
of the reference raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch import not_ported
from repro_torch.configs.base import ArchSpec, reduced

__all__ = ["ArchSpec", "reduced", "ARCH_IDS", "get_spec"]

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "gemma3-4b": "gemma3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    mod = _MODULES.get(arch_id)
    if mod is None:
        raise not_ported(f"architecture {arch_id!r} (the port has "
                         f"{sorted(_MODULES)})")
    return importlib.import_module(f"repro_torch.configs.{mod}").SPEC
