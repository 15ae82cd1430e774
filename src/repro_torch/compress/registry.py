"""Compressor registry (the port of ``repro.compress.registry``).

``make_compressor("topk", density=0.3)`` builds from a name;
``register("my-comp", MyCompressor)`` adds an entry.  The names are the
reference's.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.compress.compressors import (
    Compose, Compressor, Identity, Int8Sync, QuantQr, TopK)

_REGISTRY: Dict[str, Callable[..., Compressor]] = {}


def register(name: str, ctor: Callable[..., Compressor],
             *, overwrite: bool = False) -> None:
    key = name.lower()
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"compressor {name!r} already registered")
    _REGISTRY[key] = ctor


def available() -> list[str]:
    return sorted(_REGISTRY)


def make_compressor(name: str, **kwargs) -> Compressor:
    """Factory: ``make_compressor("topk", density=0.3)``."""
    try:
        ctor = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; have {available()}") from None
    return ctor(**kwargs)


for _name, _ctor in [
    ("identity", Identity),
    ("none", Identity),
    ("topk", TopK),
    ("quant", QuantQr),
    ("qr", QuantQr),
    ("topk+quant", Compose),
    ("double", Compose),
    ("int8", Int8Sync),
    ("int8-sync", Int8Sync),
]:
    register(_name, _ctor)
