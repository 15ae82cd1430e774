"""Wire codec layer: real packed payloads for compressed trees (DESIGN.md
§8) — the port of ``repro.compress.wire``, with its model-sharded wire
(§9: :func:`encode_shard_local` / :func:`decode_shard_local`).

The compressors are *transforms*: they return a dense tree whose zeros and
levels represent the compressed message, plus a :class:`BitsReport` of
what it would cost.  A codec's ``encode(comp, stacked, keys)`` produces the
packed buffers a client actually sends, and ``decode(payload)`` rebuilds
the transform's output on the server.  On the port's stacked trees every
buffer carries a leading client axis ``s``, so one ``encode`` call is
``jax.vmap(wire.encode)`` of the reference; :attr:`Payload.nbytes` stays
per client.

Codecs (``check_supported`` names the mapping):

* ``dense`` — ``Identity`` and ``TopK(density >= 1)``: raw values at the
  leaf dtype's width.
* ``topk`` — ``TopK(impl="select")``: per leaf, a static capacity
  ``cap = k(density)`` of int32 indices (uint32 bit patterns) plus ``cap``
  values at the leaf dtype.  Empty slots carry the sentinel index ``n``
  and are dropped by the decode scatter; magnitude ties beyond ``cap``
  keep the lowest-index ``cap``.
* ``qr`` — ``QuantQr`` (and ``Compose(TopK(density >= 1), QuantQr)``):
  one (1+r)-bit code per scalar (sign bit and r level bits), bit-plane
  packed into 32-bit words, plus one fp32 norm per leaf.  The top level
  ``2**r`` saturates to ``2**r - 1``; everywhere else the decode is
  bit-equal to the transform.
* ``topk_qr`` — ``Compose(TopK, QuantQr)``: ``cap`` slot indices as in
  ``topk``, the survivors' (1+r)-bit codes of the TopK-masked leaf
  bit-plane packed at the capacity (code 0 in empty slots), and one fp32
  norm per leaf (the masked leaf's).  Saturates as ``qr`` does.
* ``int8`` — ``Int8Sync``: leaf-shaped int8 levels plus one fp32 scale
  per leaf.

Uplink buffers are uint32 bit patterns in int32 containers, 4 bytes each,
as in the reference.  The reports are computed as the transforms compute
them, so account and packed rounds see identical bit metrics;
``padding_bits`` is the slack between measured and accounted bits.

Over a model axis (§9) each model rank packs only its slice of every
sharded leaf (:func:`sharded_wire_spec` names the layout): TopK against
the whole leaf's threshold (the radix counts summed over the ranks), Q_r
against the whole leaf's norm (the summed squares), with the bits equal to
the unsharded wire's.

``scope="tensor"`` codecs emit one *unit* per leaf; ``scope="global"``
flattens each client's tree to one ``(s, n_total)`` unit at the leaves'
promoted dtype first, as the transforms do, and splits the decode again.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.compress.compressors import (
    Compose, Compressor, Identity, Int8Sync, QuantQr, TopK, flat_rows)
from repro_torch.compress.report import (
    FLOAT_BITS, INDEX_BITS, BitsReport, dense_report, leaf_value_bits,
    per_client)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.qr_pack import MAX_R

PyTree = Any


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static description of a packed payload — everything the decoder
    needs: codec, tree structure, per-leaf shapes and dtypes (one
    client's), the sparse capacities, and the packed bytes per client."""

    codec: str                       # dense | topk | qr | topk_qr | int8
    scope: str                       # tensor | global
    treedef: Any                     # the tree's structure, leaves None
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    caps: Tuple[int, ...] = ()       # per-unit sparse capacity (topk codecs)
    r: int = 0                       # level bits (qr / topk_qr / int8)
    nbytes: int = 0                  # packed payload bytes per client
    # model-sharded wire (§9): ranks over the model axis, and each leaf's
    # sharded dimension (None: replicated; () for an unsharded spec)
    model_shards: int = 1
    model_dims: Tuple[Optional[int], ...] = ()


@dataclasses.dataclass
class Payload:
    """Packed wire buffers: ``data[leaf]`` is that leaf's buffer tuple in
    codec order, each buffer with a leading client axis."""

    data: Tuple[Tuple[torch.Tensor, ...], ...]
    spec: WireSpec

    @property
    def nbytes(self) -> int:
        """Packed size in bytes per client."""
        return self.spec.nbytes


def _buffers_nbytes(data) -> int:
    """Bytes of one client's buffers (the leading client axis excluded)."""
    return int(sum(b[0].numel() * b.element_size()
                   for unit in data for b in unit))


def measured_bits(payload: Payload) -> float:
    """The packed payload's wire cost in bits, per client."""
    return float(payload.nbytes) * 8.0


def padding_bits(payload: Payload, report: BitsReport):
    """Per-client slack between measured and accounted bits: ``(cap -
    nnz) * (INDEX_BITS + value width)`` for each sparse leaf whose support
    underfills its capacity (the value width is ``1 + r`` for
    ``topk_qr``), and ``(32 * ceil(m/32) - m) * (1 + r)`` word-padding
    bits per packed-code leaf of ``m`` codes (``m = n`` for ``qr``, ``m =
    cap`` for ``topk_qr``); dense and int8 payloads have none.  Tie
    overflow beyond ``cap`` makes a sparse leaf's share negative."""
    return measured_bits(payload) - report.total_bits


# --------------------------------------------------------------------------- #
# codec resolution
# --------------------------------------------------------------------------- #

def check_supported(comp: Optional[Compressor]) -> str:
    """Return the wire codec name for ``comp``, or raise ``ValueError``
    with the reference's message.  The static capacity needs the exact-k
    support, so ``TopK(impl="quantile")`` is rejected; ``Compose`` is
    supported for TopK -> QuantQr with matching scopes."""
    if comp is None or isinstance(comp, Identity):
        return "dense"
    if isinstance(comp, TopK):
        if comp.density >= 1.0:
            return "dense"
        if comp.impl != "select":
            raise ValueError(
                'wire codecs need the exact-k support: TopK(impl="select") '
                f"(got impl={comp.impl!r} — quantile keeps a data-dependent "
                "count, which has no static capacity)")
        return "topk"
    if isinstance(comp, QuantQr):
        if comp.r > MAX_R:
            raise ValueError(f"wire codec supports r <= {MAX_R}, "
                             f"got r={comp.r}")
        return "qr"
    if isinstance(comp, Int8Sync):
        return "int8"
    if isinstance(comp, Compose):
        if not (isinstance(comp.first, TopK)
                and isinstance(comp.second, QuantQr)):
            raise ValueError(
                f"wire codec supports Compose(TopK, QuantQr) only, got "
                f"{type(comp.first).__name__}->{type(comp.second).__name__}")
        if comp.first.scope != comp.second.scope:
            raise ValueError(
                f"wire Compose needs matching scopes, got "
                f"{comp.first.scope!r} -> {comp.second.scope!r}")
        if comp.second.r > MAX_R:
            raise ValueError(f"wire codec supports r <= {MAX_R}, "
                             f"got r={comp.second.r}")
        if comp.first.impl != "select":
            raise ValueError('wire Compose needs TopK(impl="select")')
        if comp.first.density >= 1.0:
            return "qr"           # dense support: pure packed-code payload
        return "topk_qr"
    raise ValueError(
        f"no wire codec for {type(comp).__name__}; supported: Identity, "
        "TopK(select), QuantQr, Compose(TopK, QuantQr), Int8Sync")


def _scope_of(comp, codec: str) -> str:
    if codec in ("dense", "int8"):
        return comp.scope if isinstance(comp, TopK) else "tensor"
    if isinstance(comp, Compose):
        return comp.first.scope
    return comp.scope


def _levels_r(comp) -> int:
    """The quantizer's level bits of a ``qr`` or ``topk_qr`` codec."""
    return comp.second.r if isinstance(comp, Compose) else comp.r


def _unit_shapes(comp, codec: str, tree: PyTree):
    """``(scope, [(n, width)])``: each unit's size and value width of one
    client's ``tree`` (one unit per leaf, or one global unit at the
    leaves' promoted dtype)."""
    scope = _scope_of(comp, codec)
    leaves = tree_util.leaves(tree)
    if scope == "global":
        dtype = functools.reduce(torch.promote_types,
                                 [l.dtype for l in leaves])
        width = torch.empty((), dtype=dtype).element_size()
        return scope, [(sum(l.numel() for l in leaves), width)]
    return scope, [(l.numel(), l.element_size()) for l in leaves]


def payload_nbytes(comp: Optional[Compressor], tree: PyTree) -> int:
    """Packed bytes of ``comp``'s wire format for one client's ``tree``,
    from shapes alone."""
    codec = check_supported(comp)
    _, units = _unit_shapes(comp, codec, tree)
    total = 0
    for n, width in units:
        if codec == "dense":
            total += n * width
        elif codec == "topk":
            total += comp._k(n) * (INDEX_BITS // 8 + width)
        elif codec == "topk_qr":
            cap = comp.first._k(n)
            total += (cap * INDEX_BITS // 8
                      + -(-cap // 32) * (1 + comp.second.r) * 4
                      + FLOAT_BITS // 8)
        elif codec == "int8":
            total += n + FLOAT_BITS // 8
        else:
            total += -(-n // 32) * (1 + _levels_r(comp)) * 4 + FLOAT_BITS // 8
    return total


# --------------------------------------------------------------------------- #
# encode / decode
# --------------------------------------------------------------------------- #

def _scatter_units(entries, unit_sizes, dtype):
    """Decode-side placement: one scatter for the whole payload.

    ``entries`` holds one ``(idx, vals)`` pair of ``(s, cap)`` slots per
    sparse leaf.  Leaf indices are offset into one concatenated index
    space and sentinels go to one extra column, which is dropped, so a
    single scatter places every leaf's survivors; the flat result is then
    split back into leaves."""
    total = sum(unit_sizes)
    offs = [0]
    for n in unit_sizes[:-1]:
        offs.append(offs[-1] + n)
    idx_all = torch.cat([
        torch.where(idx < n, idx.to(torch.int64) + off,
                    torch.full_like(idx, total, dtype=torch.int64))
        for (idx, _), n, off in zip(entries, unit_sizes, offs)], dim=1)
    val_all = torch.cat([v.to(dtype) for _, v in entries], dim=1)
    flat = torch.zeros((idx_all.shape[0], total + 1), dtype=dtype,
                       device=idx_all.device)
    flat.scatter_(1, idx_all, val_all)
    return [flat[:, off:off + n] for off, n in zip(offs, unit_sizes)]


def encode(comp: Optional[Compressor], stacked: PyTree,
           keys: Optional[torch.Tensor] = None
           ) -> Tuple[Payload, BitsReport]:
    """Pack every client's tree into the wire format of ``comp``.

    ``stacked`` carries a leading client axis ``s`` on every leaf and
    ``keys`` is the ``(s, 2)`` key batch.  Returns ``(payload, report)``
    with ``(s,)`` report vectors computed exactly as the transform
    computes them, and ``decode(payload)`` rebuilds what
    ``comp.compress(stacked, keys)`` returns.  The quantizer codecs split
    each client key as the transforms do (``Compose``'s ``(k1, k2)``
    first, then one key per leaf, the global unit taking the first), so
    packed and account rounds draw the same uniforms.
    """
    codec = check_supported(comp)
    scope = _scope_of(comp, codec)
    leaves = tree_util.leaves(stacked)
    s, dev = leaves[0].shape[0], leaves[0].device
    units = ([flat_rows(stacked)] if scope == "global"
             else [leaf.reshape(s, -1) for leaf in leaves])

    def mkspec(data, **kw):
        return WireSpec(codec=codec, scope=scope,
                        treedef=tree_util.map(lambda _: None, stacked),
                        shapes=tuple(tuple(l.shape[1:]) for l in leaves),
                        dtypes=tuple(l.dtype for l in leaves),
                        nbytes=_buffers_nbytes(data), **kw)

    if codec == "dense":
        data = tuple((u,) for u in units)
        return Payload(data, mkspec(data)), dense_report(stacked)

    if codec == "topk":
        # threshold (K1) + compaction (K5) straight to slots; the report
        # counts the survivors in leaf order, as the TopK transform
        # accumulates its nnz: the compaction's counts a leaf, or, for the
        # global unit, each leaf's share of the masked unit (K1 and K2 in
        # one launch, then K5)
        caps, data, counts = [], [], []
        for u in units:
            cap = comp._k(u.shape[1])
            if scope == "global":
                idx, vals, masked = kops.topk_slots_masked(u, cap, cap)
                off = 0
                for leaf in leaves:
                    n = leaf[0].numel()
                    counts.append((masked[:, off:off + n] != 0).sum(1))
                    off += n
            else:
                idx, vals, nnz = kops.topk_slots(u, cap, cap)
                counts.append(nnz)
            data.append((idx, vals))
            caps.append(cap)
        vb = torch.zeros(s, dtype=torch.float32, device=dev)
        ib = torch.zeros(s, dtype=torch.float32, device=dev)
        for leaf, nnz in zip(leaves, counts):
            nnzf = nnz.to(torch.float32)
            vb = vb + nnzf * leaf_value_bits(leaf)
            ib = ib + nnzf * INDEX_BITS
        data = tuple(data)
        report = BitsReport(value_bits=vb, index_bits=ib,
                            meta_bits=per_client(0.0, s, dev))
        return Payload(data, mkspec(data, caps=tuple(caps))), report

    if keys is None:
        raise ValueError(f"the {codec} codec needs an rng key")

    if codec == "int8":
        # leaf-shaped int8 levels and one scale per leaf, from the
        # transform's own encode
        levels, scales = comp.encode(stacked, keys)
        data = tuple(zip(tree_util.leaves(levels), tree_util.leaves(scales)))
        return (Payload(data, mkspec(data, r=comp.magnitude_bits)),
                comp.report(stacked))

    r = _levels_r(comp)
    if isinstance(comp, Compose):
        keys = prng.split(keys, 2)[:, 1]                    # compose's k2
    leaf_keys = prng.split(keys, len(leaves))               # (s, L, 2)
    meta = per_client(float(len(units)) * FLOAT_BITS, s, dev)

    if codec == "topk_qr":
        # threshold (K1), masked norm (K3), coded slots (K6), pack (K8);
        # the report is Compose's support-aware one, nnz from K6's counts
        # (index bits do not depend on a leaf's dtype, so the global unit's
        # count needs no split)
        ib = torch.zeros(s, dtype=torch.float32, device=dev)
        caps, data = [], []
        for j, u in enumerate(units):
            cap = comp.first._k(u.shape[1])
            idx, words, norm, nnz = kops.topk_qr_slots(u, cap, cap, r,
                                                       leaf_keys[:, j])
            ib = ib + nnz.to(torch.float32) * INDEX_BITS
            data.append((idx, words, norm))
            caps.append(cap)
        data = tuple(data)
        report = BitsReport(value_bits=ib / INDEX_BITS * (1 + r),
                            index_bits=ib, meta_bits=meta)
        return Payload(data, mkspec(data, caps=tuple(caps), r=r)), report

    # codec == "qr"
    data = tuple(kops.quantize_pack(u, r, leaf_keys[:, j])
                 for j, u in enumerate(units))
    n_total = sum(u.shape[1] for u in units)
    report = BitsReport(
        value_bits=per_client(float(n_total) * (1 + r), s, dev),
        index_bits=per_client(0.0, s, dev), meta_bits=meta)
    return Payload(data, mkspec(data, r=r)), report


def decode(payload: Payload) -> PyTree:
    """Unpack a :class:`Payload` back to the transform-output stacked tree."""
    spec = payload.spec
    sizes = [math.prod(shp) for shp in spec.shapes]
    unit_sizes = [sum(sizes)] if spec.scope == "global" else sizes
    if spec.codec in ("topk", "topk_qr"):
        if spec.codec == "topk":
            entries = payload.data
        else:
            entries = [(idx, kops.unpack_qr_values(words, spec.r, cap, norm))
                       for (idx, words, norm), cap in zip(payload.data,
                                                          spec.caps)]
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for _, v in entries])
        units = _scatter_units(entries, unit_sizes, dtype)
    elif spec.codec == "qr":
        units = [kops.unpack_qr_values(words, spec.r, n, norm)
                 for (words, norm), n in zip(payload.data, unit_sizes)]
    elif spec.codec == "int8":
        units = [q.to(torch.float32).reshape(q.shape[0], -1) * sc[:, None]
                 for q, sc in payload.data]
    else:
        units = [bufs[0] for bufs in payload.data]
    if spec.scope == "global":
        # the global unit back to the leaves' slices
        offs = [0]
        for n in sizes[:-1]:
            offs.append(offs[-1] + n)
        units = [units[0][:, off:off + n] for off, n in zip(offs, sizes)]
    parts = [u.reshape((u.shape[0],) + shp).to(dt)
             for u, shp, dt in zip(units, spec.shapes, spec.dtypes)]
    return tree_util.unflatten(spec.treedef, parts)


# --------------------------------------------------------------------------- #
# the model-sharded wire (DESIGN.md §9): shard-local encode / decode
# --------------------------------------------------------------------------- #
#
# With the clients composed with a model axis, each model rank packs the
# slots of its own slice of every sharded leaf, against the exact whole-leaf
# TopK threshold (each radix pass's counts summed over the ranks) or the
# whole leaf's l2 norm (one summed sum of squares).  The gathered uplink then
# moves each rank's buffers, ~1/m of a client's payload a rank.  Replicated
# leaves (biases, norms: whatever the placement rules leave whole) are packed
# alike on every rank and shipped once.

def shard_cap(k_global: int, model_shards: int, n_local: int) -> int:
    """Static slot capacity of one shard of a sharded sparse leaf: the
    ``ceil(k/m)`` slots a shard expects plus ``max(64, ceil(4 sqrt(k/m)))``
    of slack (about 4 sigma of the binomial spread), at most ``n_local``.
    A shard whose support overflows it keeps the lowest-index ``cap``; the
    bits count the summed support, not the slots."""
    base = -(-int(k_global) // int(model_shards))
    slack = max(64, math.ceil(4.0 * math.sqrt(max(base, 1))))
    return int(min(int(n_local), base + slack))


def check_sharded_supported(comp: Optional[Compressor],
                            model_shards: int) -> str:
    """:func:`check_supported` plus the shard-local rules: ``dense``,
    ``topk`` and ``qr`` have shard-local formats; ``topk_qr`` (the
    survivors' norm needs the whole support), ``int8`` (its scales come
    from whole leaves) and ``scope="global"`` (one unit cannot straddle
    sharded and replicated leaves) raise with the reference's messages."""
    codec = check_supported(comp)
    if model_shards <= 1:
        return codec
    if isinstance(comp, Compose) or codec in ("topk_qr", "int8"):
        raise ValueError(
            f"codec {codec!r} has no shard-local wire format (survivor "
            f"quantization / int8 scales need whole leaves before coding); "
            f"run wire='account' or a model=1 mesh, or use TopK(select) / "
            f"QuantQr / dense on the sharded path")
    if _scope_of(comp, codec) != "tensor":
        raise ValueError(
            'scope="global" flattens the tree to one unit, which cannot '
            "straddle model-sharded and replicated leaves; use "
            'scope="tensor" (or wire="account" / a model=1 mesh)')
    return codec


def sharded_wire_spec(comp: Optional[Compressor], tree: PyTree,
                      model_dims: Tuple[Optional[int], ...],
                      model_shards: int) -> WireSpec:
    """The :class:`WireSpec` of a shard-local payload.  ``tree`` is one
    client's tree at the whole leaves' shapes (any tensors: meta ones do);
    ``model_dims[i]`` is leaf i's sharded dimension (None: replicated),
    whose size ``model_shards`` must divide.  Caps are per shard for
    sharded leaves and ``k`` for replicated ones; ``nbytes`` is the whole
    wire's size a client: sharded buffers ``model_shards`` times,
    replicated ones and the ``qr`` norms once."""
    m = int(model_shards)
    codec = check_sharded_supported(comp, m)
    leaves = tree_util.leaves(tree)
    if len(model_dims) != len(leaves):
        raise ValueError(f"model_dims has {len(model_dims)} entries for "
                         f"{len(leaves)} leaves")
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    r = comp.r if codec == "qr" else 0
    caps, nbytes = [], 0
    for shp, dt, mdim in zip(shapes, dtypes, model_dims):
        n_glob = math.prod(shp)
        if mdim is not None:
            if not (0 <= mdim < len(shp)) or shp[mdim] % m:
                raise ValueError(
                    f"leaf shape {shp}: model dim {mdim} does not divide "
                    f"into {m} shards")
            n_loc = n_glob // m
        else:
            n_loc = n_glob
        if codec == "dense":
            nbytes += n_glob * dt.itemsize
        elif codec == "topk":
            k_glob = comp._k(n_glob)
            if mdim is not None:
                cap = shard_cap(k_glob, m, n_loc)
                nbytes += m * cap * (INDEX_BITS // 8 + dt.itemsize)
            else:
                cap = k_glob
                nbytes += cap * (INDEX_BITS // 8 + dt.itemsize)
            caps.append(cap)
        else:                                 # qr
            copies = m if mdim is not None else 1
            nbytes += copies * -(-n_loc // 32) * (1 + r) * 4 + FLOAT_BITS // 8
    return WireSpec(codec=codec, scope="tensor",
                    treedef=tree_util.map(lambda _: None, tree),
                    shapes=shapes, dtypes=dtypes, caps=tuple(caps), r=r,
                    nbytes=int(nbytes), model_shards=m,
                    model_dims=tuple(model_dims))


def per_device_payload_nbytes(spec: WireSpec) -> int:
    """One model rank's share of one client's packed payload, in bytes:
    its sharded buffers and every replicated one (``qr`` norms included).
    ``spec.nbytes`` for an unsharded spec; across the axis, ``m`` x the
    sharded part + the replicated part == ``spec.nbytes``."""
    if spec.model_shards <= 1:
        return spec.nbytes
    total, ci = 0, 0
    for n_loc, dt in zip(_local_sizes(spec), spec.dtypes):
        if spec.codec == "dense":
            total += n_loc * dt.itemsize
        elif spec.codec == "topk":
            total += spec.caps[ci] * (INDEX_BITS // 8 + dt.itemsize)
            ci += 1
        else:                                 # qr
            total += -(-n_loc // 32) * (1 + spec.r) * 4 + FLOAT_BITS // 8
    return int(total)


def _local_sizes(spec: WireSpec):
    """Each leaf's size on one model rank under ``spec``."""
    return [math.prod(shp) // (spec.model_shards if mdim is not None else 1)
            for shp, mdim in zip(spec.shapes, spec.model_dims)]


def _local_shape(shp, mdim, m):
    if mdim is None:
        return tuple(shp)
    return tuple(d // m if i == mdim else d for i, d in enumerate(shp))


def encode_shard_local(comp: Optional[Compressor], stacked_loc: PyTree,
                       spec: WireSpec, keys: Optional[torch.Tensor] = None,
                       *, model_rank: int, model_sum,
                       counts: Optional[dict] = None):
    """This model rank's shard-local encode of its clients' rows.

    ``stacked_loc`` holds, for each of the rank's ``s_loc`` clients (the
    leading axis), this rank's slice of every leaf ``spec`` names sharded
    and the replicated leaves whole; ``keys`` is the ``(s_loc, 2)`` key
    batch.  ``model_sum(t)`` sums a tensor over the model ranks (integer
    counts exactly, floats in one fixed order).  One launch a leaf for all
    the rows.  Returns ``(data, report)``: this rank's buffers in
    ``spec``'s unit order, each with the client axis, and the whole wire's
    :class:`BitsReport` (``(s_loc,)`` vectors, bit-equal to the unsharded
    :func:`encode`'s):

    * ``topk``: the summed-count walk (every sharded leaf's counts of a
      digit in one reduction) and K5 at the whole leaf's threshold and the
      per-shard cap; each leaf's support counted over the model ranks (one
      reduction) and accumulated in leaf order, as :func:`encode` does;
    * ``qr``: each row's sum of squares summed over the ranks (one
      reduction for every leaf), its root the norm, and K7's keyed entry
      with the client's leaf key folded with ``model_rank`` for a sharded
      leaf (as it is for a replicated one): the same quantizer as the
      unsharded wire, another dither;
    * ``dense``: the slices as they are.

    ``counts``, when a dict, receives the ``topk`` support counts: ``nnz``
    (``(s_loc, L)``, summed) and ``nnz_local`` (this rank's)."""
    leaves = tree_util.leaves(stacked_loc)
    s, dev = leaves[0].shape[0], leaves[0].device
    units = [leaf.reshape(s, -1) for leaf in leaves]

    if spec.codec == "dense":
        data = tuple((u,) for u in units)
        vb = float(sum(math.prod(shp) * dt.itemsize * 8
                       for shp, dt in zip(spec.shapes, spec.dtypes)))
        return data, BitsReport(value_bits=per_client(vb, s, dev),
                                index_bits=per_client(0.0, s, dev),
                                meta_bits=per_client(0.0, s, dev))

    if spec.codec == "topk":
        sharded = [i for i, d in enumerate(spec.model_dims) if d is not None]
        n_glob = [math.prod(spec.shapes[i]) for i in sharded]
        slots = dict(zip(sharded, kops.topk_slots_sharded(
            [units[i] for i in sharded], [comp._k(n) for n in n_glob],
            [spec.caps[i] for i in sharded], n_glob, model_sum)
            if sharded else ()))
        for i, u in enumerate(units):
            if i not in slots:
                slots[i] = kops.topk_slots(u, spec.caps[i], spec.caps[i])
        data = tuple(slots[i][:2] for i in range(len(units)))
        nnz_local = torch.stack([slots[i][2] for i in range(len(units))],
                                dim=1)                          # (s, L)
        # one reduction for every leaf's count; a replicated leaf's count
        # is every rank's and stays as it is
        mask = torch.tensor([d is not None for d in spec.model_dims],
                            device=dev)
        nnz = torch.where(mask, model_sum(nnz_local), nnz_local)
        if counts is not None:
            counts.update(nnz=nnz, nnz_local=nnz_local)
        vb = torch.zeros(s, dtype=torch.float32, device=dev)
        ib = torch.zeros(s, dtype=torch.float32, device=dev)
        for i, dt in enumerate(spec.dtypes):
            nnzf = nnz[:, i].to(torch.float32)
            vb = vb + nnzf * (dt.itemsize * 8)
            ib = ib + nnzf * INDEX_BITS
        return data, BitsReport(value_bits=vb, index_bits=ib,
                                meta_bits=per_client(0.0, s, dev))

    # codec == "qr"
    if keys is None:
        raise ValueError("the qr codec needs an rng key")
    leaf_keys = prng.split(keys, len(units))                    # (s, L, 2)
    ss = torch.stack([kops.sum_squares(u) for u in units], dim=1)
    mask = torch.tensor([d is not None for d in spec.model_dims], device=dev)
    norms = torch.sqrt(torch.where(mask, model_sum(ss), ss))   # one sum
    data = []
    for i, u in enumerate(units):
        key = leaf_keys[:, i]
        if spec.model_dims[i] is not None:
            key = prng.fold_in(key, model_rank)
        norm = norms[:, i].contiguous()
        data.append((kops.quantize_pack_global_norm(u, spec.r, key, norm),
                     norm))
    n_total = sum(math.prod(shp) for shp in spec.shapes)
    report = BitsReport(
        value_bits=per_client(float(n_total) * (1 + spec.r), s, dev),
        index_bits=per_client(0.0, s, dev),
        meta_bits=per_client(float(len(units)) * FLOAT_BITS, s, dev))
    return tuple(data), report


def decode_shard_local(data, spec: WireSpec) -> PyTree:
    """The inverse of :func:`encode_shard_local` on one model rank's
    buffers: the stacked tree of that rank's slices (each leaf at its
    local shape, the model dimension divided by ``model_shards``), K9's
    values entry for ``qr`` and one scatter for ``topk``."""
    sizes = _local_sizes(spec)
    if spec.codec == "topk":
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for _, v in data])
        units = _scatter_units(list(data), sizes, dtype)
    elif spec.codec == "qr":
        units = [kops.unpack_qr_values(words, spec.r, n, norm)
                 for (words, norm), n in zip(data, sizes)]
    else:                                     # dense
        units = [bufs[0] for bufs in data]
    parts = [u.reshape((u.shape[0],)
                       + _local_shape(shp, mdim, spec.model_shards)).to(dt)
             for u, shp, dt, mdim in zip(units, spec.shapes, spec.dtypes,
                                         spec.model_dims)]
    return tree_util.unflatten(spec.treedef, parts)
