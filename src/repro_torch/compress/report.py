"""Exact wire-cost accounting for compressed payloads (the port of
``repro.compress.report``).

A :class:`BitsReport` states the bits needed to transmit a payload,
counted from the payload actually produced.  On the port's stacked trees
every bucket is a float32 ``(s,)`` tensor, one entry per client (what
``jax.vmap(comp.compress)`` returns in the reference):

* ``value_bits`` — the numeric payload (fp32 values, sign+level codes);
* ``index_bits`` — coordinate indices of sparse (value, index) payloads;
* ``meta_bits``  — side information: per-tensor norms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from repro_torch import tree as tree_util

Scalar = Union[float, torch.Tensor]

FLOAT_BITS = 32  # uncompressed fp32 scalar payload, as accounted in the paper
INDEX_BITS = 32  # index payload for sparse (value, index) encoding


def leaf_value_bits(x: Any) -> int:
    """Wire bits of one raw scalar of ``x``'s dtype (bf16 -> 16, fp32 -> 32)."""
    return x.element_size() * 8


@dataclasses.dataclass
class BitsReport:
    value_bits: Scalar = 0.0
    index_bits: Scalar = 0.0
    meta_bits: Scalar = 0.0

    @property
    def total_bits(self) -> Scalar:
        return self.value_bits + self.index_bits + self.meta_bits


def dense_bits(tree: Any) -> float:
    """Bits to send ``tree`` uncompressed: each leaf's dtype width per
    scalar (host-side float)."""
    return float(sum(x.numel() * leaf_value_bits(x)
                     for x in tree_util.leaves(tree)))


def per_client(value: float, s: int, device) -> torch.Tensor:
    """A host-side constant as the ``(s,)`` float32 per-client vector."""
    return torch.full((s,), float(value), dtype=torch.float32, device=device)


def dense_report(stacked: Any) -> BitsReport:
    """Per-client bits of the uncompressed payload of a stacked tree (one
    client's ``dense_bits``, as ``(s,)`` vectors)."""
    leaf = tree_util.leaves(stacked)[0]
    s, dev = leaf.shape[0], leaf.device
    bits = dense_bits(tree_util.map(lambda x: x[0], stacked))
    return BitsReport(value_bits=per_client(bits, s, dev),
                      index_bits=per_client(0.0, s, dev),
                      meta_bits=per_client(0.0, s, dev))
