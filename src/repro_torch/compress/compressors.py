"""Compression operators (paper §3.1) on stacked client trees, with exact
bit accounting — the port of ``repro.compress.compressors``.

``compress(stacked, keys, **overrides) -> (compressed stacked tree,
BitsReport)``: every leaf carries a leading client axis ``s`` and ``keys``
is the ``(s, 2)`` per-client key batch, so one call is
``jax.vmap(comp.compress)`` of the reference (``core/clients.py:642``).
Each leaf's clients are compressed by one kernel launch over ``(s, n)``
rows.  Reports hold ``(s,)`` float32 vectors, counted from the payload
produced: TopK's nnz from ``x != 0``, Q_r's per-tensor norms.

``overrides`` are per-client parameters (DESIGN.md §5), each an ``(s,)``
tensor: ``TopK`` takes ``density`` (one k a row, K1 with per-row k) and
``QuantQr`` takes ``r`` (one level count a row, K4 with per-row levels);
``Compose`` routes each to its stage.  ``param_overrides()`` names what a
compressor accepts and ``validate_override`` checks the values.

Two granularities: ``scope="tensor"`` (per-leaf TopK and norms) and
``scope="global"`` (the concatenated leaves, one ``(s, n_total)`` row a
client, at the leaves' promoted dtype, then split again).  TopK's
``impl="quantile"`` thresholds at ``jnp.quantile``'s linear interpolation
of the sorted magnitudes, computed as the JAX package computes it.

Ported here: ``Identity``, ``TopK``, ``QuantQr``, ``Compose`` (paper
Appendix B.3's double compression, support-aware bits for TopK -> QuantQr)
and ``Int8Sync`` (int8 levels + one fp32 scale per tensor).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
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


def flat_rows(stacked: PyTree) -> torch.Tensor:
    """The ``scope="global"`` unit: each client's leaves concatenated into
    one ``(s, n_total)`` row at their promoted dtype (``jnp.concatenate``'s
    promotion)."""
    leaves = tree_util.leaves(stacked)
    dtype = functools.reduce(torch.promote_types, [l.dtype for l in leaves])
    s = leaves[0].shape[0]
    return torch.cat([l.reshape(s, -1).to(dtype) for l in leaves], dim=1)


def split_rows(rows: torch.Tensor, like: PyTree) -> PyTree:
    """Inverse of :func:`flat_rows`: ``(s, n_total)`` rows back to
    ``like``'s leaves, shapes and dtypes."""
    parts, off = [], 0
    for leaf in tree_util.leaves(like):
        n = leaf[0].numel()
        parts.append(rows[:, off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_util.unflatten(like, parts)


def _map_rows(stacked: PyTree, scope: str, fn) -> PyTree:
    """Apply ``fn((s, n) rows, leaf index)`` per leaf, or once to the
    global unit (leaf index 0)."""
    if scope == "global":
        return split_rows(fn(flat_rows(stacked), 0), stacked)
    s, _ = _clients(stacked)
    leaves = tree_util.leaves(stacked)
    return tree_util.unflatten(stacked, [
        fn(x.reshape(s, -1), j).reshape(x.shape).to(x.dtype)
        for j, x in enumerate(leaves)])


def _sparse_report(out: PyTree) -> BitsReport:
    """(value + index) bits of a sparse payload per client: each kept
    coordinate costs its leaf dtype's width plus INDEX_BITS, nnz counted
    from ``out != 0`` leaf by leaf, in leaf order."""
    s, dev = _clients(out)
    vb = torch.zeros(s, dtype=torch.float32, device=dev)
    ib = torch.zeros(s, dtype=torch.float32, device=dev)
    for x in tree_util.leaves(out):
        nnz = (x.reshape(s, -1) != 0).sum(1).to(torch.float32)
        vb = vb + nnz * leaf_value_bits(x)
        ib = ib + nnz * INDEX_BITS
    return BitsReport(value_bits=vb, index_bits=ib,
                      meta_bits=per_client(0.0, s, dev))


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v).to(dtype=torch.float32, device=device)


def override_k(density: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row TopK counts from per-client densities, as the reference
    computes them under ``vmap``: ``round(float32(d) * float32(n))`` in
    float32, half to even (``jnp.round``), as int64.  (Python's ``round``
    of a float64 product parts from it at exact halves.)"""
    return torch.round(_f32(density) * _f32(float(n))).to(torch.int64)


def quantile_threshold(mag: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Each row's ``jnp.quantile(mag[row], q[row])`` (linear method), in
    the installed jax's float32 order: ``h = q * (n - 1)``, ``lo, hi =
    floor(h), ceil(h)`` clamped to ``[0, n - 1]``, then ``sorted[lo] * (1 -
    (h - lo)) + sorted[hi] * (h - lo)``, each a float32 operation of its
    own; a row holding a NaN gives NaN.  ``mag`` is ``(rows, n)`` float32
    and ``q`` a float32 scalar or ``(rows,)`` tensor.  The JAX package runs
    it as jnp, with no Pallas kernel; these are plain torch ops on the
    tensor's device."""
    rows, n = mag.shape
    srt = torch.sort(mag, dim=1).values
    nf = torch.tensor(float(n), dtype=torch.float32, device=mag.device)
    h = _f32(q, mag.device).expand(rows) * (nf - 1)
    lo, hi = torch.floor(h), torch.ceil(h)
    hw = h - lo
    lw = 1 - hw
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    lo = torch.clamp(lo, zero, nf - 1).to(torch.int64)[:, None]
    hi = torch.clamp(hi, zero, nf - 1).to(torch.int64)[:, None]
    low = srt.gather(1, lo)[:, 0] * lw
    high = srt.gather(1, hi)[:, 0] * hw
    thr = low + high
    return torch.where(torch.isnan(mag).any(1), float("nan"), thr)


class Compressor:
    """Base class.  Subclasses implement ``compress``; ``apply`` drops the
    report (FedComLoc-Local, where nothing is sent)."""

    def compress(self, stacked: PyTree, keys: Optional[torch.Tensor] = None,
                 **overrides) -> Tuple[PyTree, BitsReport]:
        raise NotImplementedError

    def apply(self, stacked: PyTree, keys: Optional[torch.Tensor] = None,
              **overrides) -> PyTree:
        return self.compress(stacked, keys, **overrides)[0]

    def param_overrides(self) -> Tuple[str, ...]:
        """Per-client override names ``compress`` accepts."""
        return ()

    def validate_override(self, name: str, values) -> None:
        """Host-side range check of per-client override values."""


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    def compress(self, stacked, keys=None):
        return stacked, dense_report(stacked)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the ``density`` fraction of largest-|.| entries of each leaf
    (``scope="tensor"``) or of the whole tree (``"global"``) (Def. 3.1),
    ties at the threshold kept.  ``impl="select"`` thresholds at the exact
    k-th magnitude (K1 and K2), ``"quantile"`` at ``jnp.quantile`` of the
    magnitudes.  Bits: (leaf dtype width + INDEX_BITS) per coordinate of
    the actual support; dense at ``density >= 1``."""

    density: float = 0.1
    scope: str = "tensor"
    impl: str = "select"

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.scope not in ("tensor", "global"):
            raise ValueError(f"unknown scope {self.scope!r}")
        if self.impl not in ("select", "quantile"):
            raise ValueError(f"unknown impl {self.impl!r}")

    def _k(self, size: int) -> int:
        return max(1, min(size, int(round(self.density * size))))

    def _mask(self, x: torch.Tensor, density) -> torch.Tensor:
        """One ``(s, n)`` unit masked; ``density`` is None (the configured
        one) or the ``(s,)`` per-client override."""
        n = x.shape[1]
        if self.impl == "quantile":
            mag = x.to(torch.float32).abs()
            q = (_f32(1.0 - self.density) if density is None
                 else torch.clamp(1.0 - _f32(density), 0.0, 1.0))
            thr = quantile_threshold(mag, q)
            return torch.where(mag >= thr[:, None], x, torch.zeros_like(x))
        k = self._k(n) if density is None else override_k(density, n)
        return kops.topk_mask(x, k)

    def param_overrides(self):
        return ("density",)

    def validate_override(self, name, values):
        if name == "density":
            v = np.asarray(values)
            if not ((v > 0.0) & (v <= 1.0)).all():
                raise ValueError(
                    f"density override values must be in (0, 1], got "
                    f"range [{v.min()}, {v.max()}]")

    def compress(self, stacked, keys=None, *, density=None):
        if density is None and self.density >= 1.0:
            return stacked, dense_report(stacked)
        out = _map_rows(stacked, self.scope,
                        lambda x, _: self._mask(x, density))
        rep = _sparse_report(out)
        if density is None:
            return out, rep
        # per-client densities: the payload is dense where d >= 1
        s, dev = _clients(stacked)
        dense = (_f32(density) >= 1.0).to(dev)
        return out, BitsReport(
            value_bits=torch.where(dense, dense_report(stacked).value_bits,
                                   rep.value_bits),
            index_bits=torch.where(dense, 0.0, rep.index_bits),
            meta_bits=rep.meta_bits)


@dataclasses.dataclass(frozen=True)
class QuantQr(Compressor):
    """QSGD binary quantization with ``r`` bits (Def. 3.2), per leaf
    (``scope="tensor"``) or over the whole tree (``"global"``).  Unbiased.
    Bits: sign + r-bit level per scalar, plus one fp32 norm per tensor (or
    one in all)."""

    r: int = 8
    scope: str = "tensor"

    def __post_init__(self):
        if self.r <= 0:
            raise ValueError("r must be positive")
        if self.scope not in ("tensor", "global"):
            raise ValueError(f"unknown scope {self.scope!r}")

    def param_overrides(self):
        return ("r",)

    def validate_override(self, name, values):
        if name == "r":
            v = np.asarray(values)
            if not np.issubdtype(v.dtype, np.integer) or not (v >= 1).all():
                raise ValueError(
                    f"r override values must be integers >= 1, got dtype "
                    f"{v.dtype}, min {v.min()}")

    def compress(self, stacked, keys=None, *, r=None):
        if keys is None:
            raise ValueError("QuantQr requires an rng key (stochastic rounding)")
        s, dev = _clients(stacked)
        leaves = tree_util.leaves(stacked)
        rr = self.r if r is None else torch.as_tensor(r)
        # client i's leaf j draws its uniforms from split(keys[i], L)[j]
        # (the global unit from split(keys[i], L)[0]), as the reference's
        # per-client compress does
        leaf_keys = prng.split(keys, len(leaves))           # (s, L, 2)
        out = _map_rows(stacked, self.scope, lambda x, j: kops.quantize_qr(
            x, rr, leaf_keys[:, j]))
        n_total = sum(x[0].numel() for x in leaves)
        n_norms = 1 if self.scope == "global" else len(leaves)
        if r is None:
            value = per_client(float(n_total) * (1 + self.r), s, dev)
        else:
            value = (_f32(float(n_total)) * _f32(1 + rr)).to(dev)
        return out, BitsReport(
            value_bits=value, index_bits=per_client(0.0, s, dev),
            meta_bits=per_client(float(n_norms) * FLOAT_BITS, s, dev))


@dataclasses.dataclass(frozen=True)
class Compose(Compressor):
    """Apply ``first`` then ``second`` (paper Appendix B.3: TopK -> Q_r).

    Each client key splits into ``(k1, k2)`` for the two stages, and each
    override goes to the stage that accepts it.  For the TopK -> QuantQr
    pair the report is support-aware: ``nnz * (1 + r)`` value bits (the
    quantizer's dense report at ``density >= 1``), the TopK stage's index
    bits and the quantizer's norms.  Other compositions report the second
    stage's value bits plus both stages' index bits — correct but
    conservative."""

    first: Compressor = dataclasses.field(default_factory=lambda: TopK(0.25))
    second: Compressor = dataclasses.field(default_factory=lambda: QuantQr(4))

    def param_overrides(self):
        return tuple(self.first.param_overrides()
                     + self.second.param_overrides())

    def validate_override(self, name, values):
        if name in self.first.param_overrides():
            self.first.validate_override(name, values)
        if name in self.second.param_overrides():
            self.second.validate_override(name, values)

    def compress(self, stacked, keys=None, **overrides):
        if keys is not None:
            pair = prng.split(keys, 2)                       # (s, 2, 2)
            k1, k2 = pair[:, 0], pair[:, 1]
        else:
            k1 = k2 = None
        ov1 = {k: v for k, v in overrides.items()
               if k in self.first.param_overrides()}
        ov2 = {k: v for k, v in overrides.items()
               if k in self.second.param_overrides()}
        unknown = set(overrides) - set(ov1) - set(ov2)
        if unknown:
            raise TypeError(f"unknown override(s) {sorted(unknown)} for "
                            f"{type(self.first).__name__}->"
                            f"{type(self.second).__name__}")
        mid, rep1 = self.first.compress(stacked, k1, **ov1)
        out, rep2 = self.second.compress(mid, k2, **ov2)
        if isinstance(self.first, TopK) and isinstance(self.second, QuantQr):
            nnz = rep1.index_bits / INDEX_BITS
            dev = nnz.device
            d = overrides.get("density", self.first.density)
            rr = overrides.get("r", self.second.r)
            support = nnz * (1 + (_f32(rr, dev) if "r" in overrides else rr))
            dense = _f32(d, dev) >= 1.0
            return out, BitsReport(
                value_bits=torch.where(dense, rep2.value_bits, support),
                index_bits=rep1.index_bits, meta_bits=rep2.meta_bits)
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
