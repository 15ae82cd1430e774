"""Compression operators (paper §3.1) on stacked client trees, with exact
bit accounting — the port of ``repro.compress.compressors``.

``compress(stacked, keys) -> (compressed stacked tree, BitsReport)``: every
leaf carries a leading client axis ``s`` and ``keys`` is the ``(s, 2)``
per-client key batch, so one call is ``jax.vmap(comp.compress)`` of the
reference (``core/clients.py:642``).  Each leaf's clients are compressed
by one kernel launch over ``(s, n)`` rows.  Reports hold ``(s,)`` float32
vectors, counted from the payload produced: TopK's nnz from ``x != 0``,
Q_r's per-tensor norms.

Ported here: ``Identity``, ``TopK(scope="tensor", impl="select")``,
``QuantQr(scope="tensor")``, ``Compose`` (paper Appendix B.3's double
compression, support-aware bits for TopK -> QuantQr) and ``Int8Sync``
(int8 levels + one fp32 scale per tensor).  ``scope="global"``,
``impl="quantile"`` and per-client overrides are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import not_ported, prng
from repro_torch import tree as tree_util
from repro_torch.compress.report import (
    FLOAT_BITS, INDEX_BITS, BitsReport, dense_report, leaf_value_bits,
    per_client)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

PyTree = Any


def _clients(stacked: PyTree) -> Tuple[int, torch.device]:
    leaf = tree_util.leaves(stacked)[0]
    return leaf.shape[0], leaf.device


class Compressor:
    """Base class.  Subclasses implement ``compress``; ``apply`` drops the
    report (FedComLoc-Local, where nothing is sent)."""

    def compress(self, stacked: PyTree, keys: Optional[torch.Tensor] = None
                 ) -> Tuple[PyTree, BitsReport]:
        raise NotImplementedError

    def apply(self, stacked: PyTree,
              keys: Optional[torch.Tensor] = None) -> PyTree:
        return self.compress(stacked, keys)[0]


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    def compress(self, stacked, keys=None):
        return stacked, dense_report(stacked)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the ``density`` fraction of largest-|.| entries of each leaf
    (Def. 3.1), ties at the threshold kept.  Bits: (leaf dtype width +
    INDEX_BITS) per coordinate of the actual support; dense at
    ``density >= 1``."""

    density: float = 0.1
    scope: str = "tensor"
    impl: str = "select"

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.scope != "tensor":
            raise not_ported(f"TopK scope={self.scope!r}")
        if self.impl != "select":
            raise not_ported(f"TopK impl={self.impl!r}")

    def _k(self, size: int) -> int:
        return max(1, min(size, int(round(self.density * size))))

    def compress(self, stacked, keys=None):
        if self.density >= 1.0:
            return stacked, dense_report(stacked)
        s, dev = _clients(stacked)
        vb = torch.zeros(s, dtype=torch.float32, device=dev)
        ib = torch.zeros(s, dtype=torch.float32, device=dev)

        def mask(x):
            nonlocal vb, ib
            n = x[0].numel()
            out = kops.topk_mask(x.reshape(s, n), self._k(n)).reshape(x.shape)
            nnz = (out.reshape(s, n) != 0).sum(1).to(torch.float32)
            vb = vb + nnz * leaf_value_bits(out)
            ib = ib + nnz * INDEX_BITS
            return out

        out = tree_util.map(mask, stacked)
        return out, BitsReport(value_bits=vb, index_bits=ib,
                               meta_bits=per_client(0.0, s, dev))


@dataclasses.dataclass(frozen=True)
class QuantQr(Compressor):
    """QSGD binary quantization with ``r`` bits (Def. 3.2), per leaf.
    Unbiased.  Bits: sign + r-bit level per scalar, plus one fp32 norm per
    tensor."""

    r: int = 8
    scope: str = "tensor"

    def __post_init__(self):
        if self.r <= 0:
            raise ValueError("r must be positive")
        if self.scope != "tensor":
            raise not_ported(f"QuantQr scope={self.scope!r}")

    def compress(self, stacked, keys=None):
        if keys is None:
            raise ValueError("QuantQr requires an rng key (stochastic rounding)")
        s, dev = _clients(stacked)
        leaves = tree_util.leaves(stacked)
        # client i's leaf j draws its uniforms from split(keys[i], L)[j],
        # as the reference's per-client compress does
        leaf_keys = prng.split(keys, len(leaves))           # (s, L, 2)
        new = []
        for j, x in enumerate(leaves):
            n = x[0].numel()
            new.append(kops.quantize_qr(x.reshape(s, n), self.r,
                                        leaf_keys[:, j]).reshape(x.shape))
        out = tree_util.unflatten(stacked, new)
        n_total = sum(x[0].numel() for x in leaves)
        return out, BitsReport(
            value_bits=per_client(float(n_total) * (1 + self.r), s, dev),
            index_bits=per_client(0.0, s, dev),
            meta_bits=per_client(float(len(leaves)) * FLOAT_BITS, s, dev))


@dataclasses.dataclass(frozen=True)
class Compose(Compressor):
    """Apply ``first`` then ``second`` (paper Appendix B.3: TopK -> Q_r).

    Each client key splits into ``(k1, k2)`` for the two stages.  For the
    TopK -> QuantQr pair the report is support-aware: ``nnz * (1 + r)``
    value bits (the quantizer's dense report at ``density >= 1``), the
    TopK stage's index bits and the quantizer's norms.  Other compositions
    report the second stage's value bits plus both stages' index bits —
    correct but conservative."""

    first: Compressor = dataclasses.field(default_factory=lambda: TopK(0.25))
    second: Compressor = dataclasses.field(default_factory=lambda: QuantQr(4))

    def compress(self, stacked, keys=None):
        if keys is not None:
            pair = prng.split(keys, 2)                       # (s, 2, 2)
            k1, k2 = pair[:, 0], pair[:, 1]
        else:
            k1 = k2 = None
        mid, rep1 = self.first.compress(stacked, k1)
        out, rep2 = self.second.compress(mid, k2)
        if isinstance(self.first, TopK) and isinstance(self.second, QuantQr):
            nnz = rep1.index_bits / INDEX_BITS
            value = (rep2.value_bits if self.first.density >= 1.0
                     else nnz * (1 + self.second.r))
            return out, BitsReport(value_bits=value,
                                   index_bits=rep1.index_bits,
                                   meta_bits=rep2.meta_bits)
        return out, BitsReport(value_bits=rep2.value_bits,
                               index_bits=rep1.index_bits + rep2.index_bits,
                               meta_bits=rep2.meta_bits)


@dataclasses.dataclass(frozen=True)
class Int8Sync(Compressor):
    """Int8 payload codec: unbiased Q_r rounding with ``magnitude_bits``
    level bits (<= 7, so level * sign fits int8), clipped to [-127, 127],
    plus one fp32 scale ``norm / 2**magnitude_bits`` per tensor.
    ``compress`` is ``decode(encode(.))``.  The norm is a plain
    ``sqrt(sum(x * x))``, as the reference takes it (no kernel there).
    Bits: 8 per scalar plus one fp32 scale per tensor."""

    magnitude_bits: int = 7

    def __post_init__(self):
        if not (0 < self.magnitude_bits <= 7):
            raise ValueError("magnitude_bits must be in [1, 7] to fit int8")

    def encode(self, stacked: PyTree, keys: torch.Tensor):
        """``(levels, scales)``: leaf-shaped int8 levels ``(s, ...)`` and
        ``(s,)`` float32 scales per leaf; client ``i``'s leaf ``j`` draws
        its uniforms from ``split(keys[i], L)[j]``."""
        levels = float(2 ** self.magnitude_bits)
        s, _ = _clients(stacked)
        leaves = tree_util.leaves(stacked)
        leaf_keys = prng.split(keys, len(leaves))           # (s, L, 2)
        payload, scales = [], []
        for j, leaf in enumerate(leaves):
            xf = leaf.to(torch.float32).reshape(s, -1)
            norm = torch.sqrt(torch.sum(xf * xf, dim=1))
            safe = torch.where(norm > 0, norm, torch.ones_like(norm))[:, None]
            y = xf.abs() / safe
            lo = torch.floor(levels * y)
            frac = levels * y - lo
            u = prng.uniform(leaf_keys[:, j], xf.shape[1], device=xf.device)
            q = (lo + (u < frac).to(torch.float32)) * ref.jax_sign(xf)
            payload.append(torch.clamp(q, -127, 127).to(torch.int8)
                           .reshape(leaf.shape))
            scales.append(norm / levels)
        return (tree_util.unflatten(stacked, payload),
                tree_util.unflatten(stacked, scales))

    @staticmethod
    def decode(payload: PyTree, scales: PyTree, dtype_like: PyTree) -> PyTree:
        """Dequantize: ``q * scale`` per leaf, at ``dtype_like``'s dtypes."""
        out = [(q.to(torch.float32)
                * sc.reshape((-1,) + (1,) * (q.dim() - 1))).to(like.dtype)
               for q, sc, like in zip(tree_util.leaves(payload),
                                      tree_util.leaves(scales),
                                      tree_util.leaves(dtype_like))]
        return tree_util.unflatten(payload, out)

    def report(self, stacked: PyTree) -> BitsReport:
        s, dev = _clients(stacked)
        leaves = tree_util.leaves(stacked)
        n = sum(x[0].numel() for x in leaves)
        return BitsReport(value_bits=per_client(float(n) * 8.0, s, dev),
                          index_bits=per_client(0.0, s, dev),
                          meta_bits=per_client(float(len(leaves)) * FLOAT_BITS,
                                               s, dev))

    def compress(self, stacked, keys=None):
        if keys is None:
            raise ValueError("Int8Sync requires an rng key (stochastic rounding)")
        payload, scales = self.encode(stacked, keys)
        return self.decode(payload, scales, stacked), self.report(stacked)
