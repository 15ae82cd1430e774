"""Compression operators and bit accounting (the port of ``repro.compress``)."""

from repro_torch.compress.compressors import (
    Compose, Compressor, Identity, Int8Sync, QuantQr, TopK)
from repro_torch.compress.registry import available, make_compressor, register
from repro_torch.compress.report import (
    FLOAT_BITS, INDEX_BITS, BitsReport, dense_bits, leaf_value_bits)

__all__ = ["BitsReport", "Compose", "Compressor", "FLOAT_BITS", "INDEX_BITS",
           "Identity", "Int8Sync", "QuantQr", "TopK", "available",
           "dense_bits", "leaf_value_bits", "make_compressor", "register"]
