"""Compression operators and bit accounting (the port of ``repro.compress``)."""

from repro_torch.compress.compressors import (
    Compressor, Identity, QuantQr, TopK)
from repro_torch.compress.report import (
    FLOAT_BITS, INDEX_BITS, BitsReport, dense_bits, leaf_value_bits)

__all__ = ["BitsReport", "Compressor", "FLOAT_BITS", "INDEX_BITS",
           "Identity", "QuantQr", "TopK", "dense_bits", "leaf_value_bits"]
