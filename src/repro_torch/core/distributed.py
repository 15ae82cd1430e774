"""Client-axis parallelism on ``torch.distributed`` (DESIGN.md §6), the
port of ``repro.core.distributed``.

The paper's rounds are embarrassingly parallel along the sampled-client
axis.  :class:`ShardCtx` splits that axis over the ranks of a process
group: rank ``r`` of ``D`` owns rows ``[r s/D, (r+1) s/D)`` of the ``s``
sampled clients and runs their local SGD, compression and packed encode;
every cross-client operation of the round body is a collective on the
group:

* ``all_clients`` / ``all_clients_tree`` — ``all_gather_into_tensor`` in
  rank order, the inverse of ``shard``;
* ``psum``, ``mean_clients``, ``sum_clients`` — ``all_reduce(SUM)``
  (``mean_clients`` in one flat float32 buffer);
* ``scatter_rows`` — every rank's rows and indices gathered, and all
  ``s`` rows written on every rank: exact, because ``replace=False``
  sampling makes the rows disjoint.

Determinism contract (``tests/test_torch_distributed.py``): per-client
keys are split from the full ``(s,)`` chain and then sliced, so each
client computes what it computes unsharded; the metric scalars (bits,
``client_steps``, ``client_uplink_bits``, ``sim_time``) come from
gathered full vectors through the unsharded formula and are bit-identical
at any rank count, while all-reduced model trees are allclose (the
summation order changes with D).  At D = 1 everything, parameters
included, is bit-identical.  The state — server model, the ``(n, ...)``
per-client store — is replicated: every rank holds it whole and ends the
round with the same values.

The port's packed payload words are ``int32`` (the reference's are
``uint32``, which gloo refuses), so the payload gather moves them as they
are under gloo and NCCL alike.  A collective on a tensor that lives on
another device than the group's (a host ``(s,)`` plan vector under NCCL)
copies it to the group's device and back.

:class:`ModelShardCtx` is the composed ``("clients", "data", "model")``
mesh (DESIGN.md §9) with the shard-local wire.  The reference runs that
regime as one GSPMD program: the per-client compute keeps global
semantics with placement hints, so XLA splits the local SGD's math over
``model``, and only the wire runs in manual ``shard_map`` islands.  torch
has no GSPMD, so the port gets the same values another way:

* the sampled clients split over the ``clients`` sub-group exactly as
  :class:`ShardCtx` splits them (slicing, ``mean_clients``,
  ``scatter_rows``, metric gathers);
* every rank of a model group runs the same local SGD on full weights
  (so in this slice the model axis cuts the wire's bytes a rank, not the
  weights' memory; tensor-parallel compute on ``torch.distributed.tensor``
  comes with the pod-sharded round, ROADMAP Queue A);
* the wire runs shard-local over the ``model`` sub-group: each rank packs
  its slice of every sharded leaf (``compress/wire.py``'s
  ``encode_shard_local``: the TopK threshold from radix counts summed over
  the group, the Q_r norm from summed squares), the packed buffers are
  gathered (in one byte tensor) over the model group and then the
  clients group, and every rank decodes each shard and joins the slices
  along each leaf's model dimension.  The state stays replicated, as under :class:`ShardCtx`.

The bits equal the unsharded wire's; the decoded values equal it too
unless a leaf's support has ties at its threshold beyond ``k`` (the
unsharded wire keeps the lowest-index ``k``, a shard its own cap) or a
shard's support overflows its cap (it keeps its lowest-index ``cap``);
the Q_r dither of a sharded leaf comes from the client's leaf key folded
with the model rank.  A ``data`` axis larger than 1 with ``model`` 1
replicates the rounds over its ranks and runs the unsharded wire.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core.clients import ClientAxisCtx, RoundPlan, mask_payload
from repro_torch.sharding.specs import mesh_axes, model_dim_index

PyTree = Any

CLIENT_AXIS = "clients"


def _group_device(group) -> torch.device:
    """The device a group's collectives run on: the current card under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_group(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` as a collective on ``device`` moves it: contiguous; from a card
    to the host (gloo) in page-locked memory, which the card copies into
    and gloo reduces faster than pageable memory (PERF.md, the pod round's
    0.78 GB all-reduces)."""
    t = t.detach()
    if t.is_cuda and device.type == "cpu":
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.to(device).contiguous()


class ShardCtx(ClientAxisCtx):
    """The sampled-client axis split over the ranks of ``group``."""

    #: the name :meth:`_note` gives the client group
    axis = CLIENT_AXIS

    def __init__(self, group, n_shards: int):
        size = dist.get_world_size(group)
        if size != n_shards:
            raise ValueError(f"group has {size} ranks, not n_shards="
                             f"{n_shards}")
        self.group = group
        self.n_shards = n_shards
        self.rank = dist.get_rank(group)
        self.device = _group_device(group)

    # -- slicing ----------------------------------------------------------- #

    def local_count(self, s: int) -> int:
        return s // self.n_shards

    def shard(self, arr: torch.Tensor) -> torch.Tensor:
        nl = arr.shape[0] // self.n_shards
        return arr[self.rank * nl:(self.rank + 1) * nl]

    def shard_tree(self, tree: PyTree) -> PyTree:
        if isinstance(tree, RoundPlan):
            return RoundPlan(*(self.shard_tree(f) for f in tree))
        if tree is None:
            return None
        return tree_util.map(self.shard, tree)

    # -- collectives ------------------------------------------------------- #

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective moves it: contiguous, on the group's
        device."""
        return _to_group(t, self.device)

    def _note(self, axis: str, op: str, t: torch.Tensor) -> None:
        """Called with each collective's axis name, its name and the tensor
        it takes from this rank (a subclass may record them)."""

    def all_clients(self, vec: torch.Tensor) -> torch.Tensor:
        t = self._out(vec)
        self._note(self.axis, "all_gather", t)
        full = torch.empty((t.shape[0] * self.n_shards,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device,
                           pin_memory=t.is_pinned())
        dist.all_gather_into_tensor(full, t, group=self.group)
        return full.to(vec.device)

    def all_clients_tree(self, tree: PyTree) -> PyTree:
        return tree_util.map(self.all_clients, tree)

    def _all_reduce(self, x: torch.Tensor, group=None,
                    axis: Optional[str] = None) -> torch.Tensor:
        """``x`` summed over ``group`` (named ``axis``; the client group by
        default), ``x`` itself left as it is."""
        t = self._out(x)
        if t.data_ptr() == x.data_ptr():    # the collective writes in place
            t = t.clone()
        self._note(axis or self.axis, "all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=self.group if group is None else group)
        return t.to(x.device)

    def psum(self, x):
        return tree_util.map(self._all_reduce, x)

    def mean_clients(self, stacked: PyTree) -> PyTree:
        # the mean of the shards' equal-sized means: at D = 1 this is the
        # unsharded t.mean(0) bit for bit (the sum over one rank is a copy).
        # The means go in one flat buffer (a collective costs ~0.2 ms of
        # host time, and a model has hundreds of leaves), summed in float32
        # as the unsharded mean accumulates bf16 and f16 (float64 in a
        # buffer of its own), and cast back to each leaf's dtype
        means = [t.mean(dim=0) for t in tree_util.leaves(stacked)]
        acc = [torch.promote_types(m.dtype, torch.float32) for m in means]
        out = list(means)
        for dt in dict.fromkeys(acc):
            idx = [i for i, a in enumerate(acc) if a == dt]
            flat = self._all_reduce(torch.cat([means[i].reshape(-1).to(dt)
                                               for i in idx]))
            flat = flat / self.n_shards
            for i, part in zip(idx, flat.split([means[i].numel()
                                                for i in idx])):
                out[i] = part.view(means[i].shape).to(means[i].dtype)
        return tree_util.unflatten(stacked, out)

    def sum_clients(self, stacked: PyTree) -> PyTree:
        return tree_util.map(lambda t: self._all_reduce(t.sum(dim=0)),
                             stacked)

    def scatter_rows(self, full: PyTree, idx: torch.Tensor,
                     upd: PyTree) -> PyTree:
        """Every rank writes every shard's rows: the indices and rows are
        gathered in rank order and copied in with ``index_copy``, the
        unsharded write on the full cohort (exact: sampling without
        replacement makes the shards' rows disjoint)."""
        idx_all = self.all_clients(idx)
        return tree_util.map(
            lambda t, r: t.index_copy(0, idx_all, self.all_clients(r)),
            full, upd)


def _bytes(data) -> tuple:
    """A payload's buffers (units of ``(rows, ...)`` tensors) as one
    ``(rows, B)`` uint8 tensor, and the layout that :func:`_from_bytes`
    reads it back with: one collective moves them all."""
    flat, layout = [], []
    for unit in data:
        for b in unit:
            row = b.reshape(b.shape[0], -1)
            if row.stride(-1) != 1:     # a size-1 view may keep any stride
                row = torch.empty_like(row,
                                       memory_format=torch.contiguous_format
                                       ).copy_(row)
            row = row.contiguous().view(torch.uint8)
            flat.append(row)
            layout.append((tuple(b.shape[1:]), b.dtype, row.shape[1]))
    return torch.cat(flat, dim=1), (layout, tuple(len(u) for u in data))


def _from_bytes(flat: torch.Tensor, layout) -> tuple:
    """The inverse of :func:`_bytes` on ``flat`` ``(..., rows, B)``: the
    units of ``(..., rows) + shape`` tensors."""
    bufs, off = [], 0
    lead = tuple(flat.shape[:-1])
    for shape, dtype, nb in layout[0]:
        part = flat[..., off:off + nb].contiguous().view(dtype)
        bufs.append(part.reshape(lead + shape))
        off += nb
    it = iter(bufs)
    return tuple(tuple(next(it) for _ in range(n)) for n in layout[1])


def _gather(t: torch.Tensor, group, size: int, device) -> torch.Tensor:
    """``(size,) + t.shape``: every rank's ``t`` of ``group`` in rank
    order, on the group's ``device``."""
    src = _to_group(t, device)
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=device,
                      pin_memory=src.is_pinned())
    dist.all_gather_into_tensor(out, src, group=group)
    return out.reshape((size,) + tuple(src.shape))


class ModelShardCtx(ShardCtx):
    """The composed clients x model regime: :class:`ShardCtx` over the
    mesh's ``clients`` axis, and the shard-local wire over its ``model``
    axis (module docstring)."""

    def __init__(self, mesh, axis: str = CLIENT_AXIS,
                 model_axis: str = "model"):
        axes = mesh_axes(mesh)
        super().__init__(mesh.get_group(axis), axes[axis])
        self.mesh = mesh
        self.model_shards = axes.get(model_axis, 1)
        self.model_group = (mesh.get_group(model_axis)
                            if model_axis in axes else None)
        self.model_rank = (dist.get_rank(self.model_group)
                           if self.model_group is not None else 0)
        self.model_device = (_group_device(self.model_group)
                             if self.model_group is not None else None)
        #: when a list, each shard-local encode appends its compressor and
        #: spec, this rank's measured bytes a client and the topk support
        #: counts
        self.record: Optional[list] = None

    # -- the model group's collectives -------------------------------------- #

    def _model_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(m,) + t.shape`` over the model group, on its device."""
        return _gather(t, self.model_group, self.model_shards,
                       self.model_device)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group: gathered, then summed in rank
        order, so every rank gets the same bits (integers exactly)."""
        return self._model_gather(t).sum(dim=0, dtype=t.dtype).to(t.device)

    # -- the shard-local wire ----------------------------------------------- #

    def _slices(self, stacked: PyTree, lead: int):
        """``(model dims, one whole tree, local tree)``: each leaf's model
        dimension by the path rules (on the shape past ``lead`` leading
        axes), the tree without its leading axis (the spec's shapes), and
        this rank's slice of every sharded leaf."""
        pairs = tree_util.leaves_with_paths(stacked)
        mdims = tuple(model_dim_index(path, tuple(leaf.shape[lead:]),
                                      self.model_shards)
                      for path, leaf in pairs)
        loc = []
        for (_, leaf), mdim in zip(pairs, mdims):
            if mdim is not None:
                leaf = leaf.chunk(self.model_shards, dim=lead + mdim)[
                    self.model_rank]
            loc.append(leaf)
        one = tree_util.map(lambda t: t[0] if lead else t, stacked)
        return mdims, one, tree_util.unflatten(stacked, loc)

    def _encode(self, comp, stacked: PyTree, keys, lead: int):
        from repro_torch.compress import wire
        mdims, one, loc = self._slices(stacked, lead)
        spec = wire.sharded_wire_spec(comp, one, mdims, self.model_shards)
        if not lead:
            loc = tree_util.map(lambda t: t.unsqueeze(0), loc)
            keys = None if keys is None else keys.unsqueeze(0)
        counts = {} if self.record is not None else None
        data, report = wire.encode_shard_local(
            comp, loc, spec, keys, model_rank=self.model_rank,
            model_sum=self.model_sum, counts=counts)
        if self.record is not None:
            self.record.append({"comp": comp, "spec": spec, "counts": counts,
                                "device_nbytes": wire._buffers_nbytes(data)})
        return wire.Payload(data, spec), report

    def _decode_gathered(self, data, spec) -> PyTree:
        """Every shard's buffers ``(m, rows, ...)`` decoded, one shard at a
        time, into each whole leaf's slice along its model dimension (a
        replicated leaf from shard 0): the ``(rows, ...)`` stack of whole
        leaves, with one shard's decode alive beside it at a time."""
        from repro_torch.compress import wire
        out = None
        for j in range(self.model_shards):
            part = tree_util.leaves(wire.decode_shard_local(
                tuple(tuple(b[j] for b in unit) for unit in data), spec))
            if out is None:
                out = [torch.empty((t.shape[0],) + tuple(shp), dtype=t.dtype,
                                   device=t.device)
                       for t, shp in zip(part, spec.shapes)]
            for whole, t, mdim in zip(out, part, spec.model_dims):
                if mdim is None:
                    if j == 0:
                        whole.copy_(t)
                else:
                    whole.narrow(1 + mdim, j * t.shape[1 + mdim],
                                 t.shape[1 + mdim]).copy_(t)
            del part
        return tree_util.unflatten(spec.treedef, out)

    def encode_payload(self, comp, plan: RoundPlan, stacked: PyTree,
                       keys: Optional[torch.Tensor] = None):
        if self.model_shards <= 1:
            return super().encode_payload(comp, plan, stacked, keys)
        if plan.comp_overrides:
            raise ValueError(
                "packed wire mode cannot carry per-client compressor "
                "overrides (static payload capacity); run them in account "
                "mode")
        return self._encode(comp, stacked, keys, lead=1)

    def gather_decoded_payload(self, payload, partf_full: torch.Tensor):
        if payload.spec.model_shards <= 1:
            return super().gather_decoded_payload(payload, partf_full)
        masked = mask_payload(payload, self.shard(partf_full))
        # every buffer in one byte tensor: (m, s_loc, B) over the model
        # group, then (D, m, s_loc, B) over the clients group, to (m, s, B)
        # in client order
        flat, layout = _bytes(masked.data)
        t = self._model_gather(flat)
        full = _gather(t, self.group, self.n_shards, self.device)
        full = full.transpose(0, 1).reshape(t.shape[0], -1, t.shape[-1])
        return self._decode_gathered(_from_bytes(full.to(flat.device),
                                                 layout), payload.spec)

    def encode_broadcast(self, comp, tree: PyTree,
                         key: Optional[torch.Tensor] = None):
        if self.model_shards <= 1:
            return super().encode_broadcast(comp, tree, key)
        return self._encode(comp, tree, key, lead=0)

    def decode_broadcast(self, payload) -> PyTree:
        if payload.spec.model_shards <= 1:
            return super().decode_broadcast(payload)
        flat, layout = _bytes(payload.data)
        data = _from_bytes(self._model_gather(flat).to(flat.device), layout)
        return tree_util.map(lambda t: t[0],
                             self._decode_gathered(data, payload.spec))


def validate_model_axis(mesh, model_cfg, axis: str = "model") -> int:
    """Check that the mesh's ``model`` axis divides the config's sharded
    dims (q/o and k/v projections, d_ff, vocab); returns the axis size (1
    when absent).  ``model_cfg`` is a ``ModelConfig`` or an ``ArchSpec``.
    Reads only the mesh's axis names and sizes."""
    axes = mesh_axes(mesh)
    m = axes.get(axis, 1)
    if m == 1:
        return 1
    cfg = getattr(model_cfg, "model", model_cfg)
    hd = getattr(cfg, "hd", None) or cfg.head_dim
    dims = {
        "n_heads*head_dim (q/o projections)": cfg.n_heads * hd,
        "n_kv_heads*head_dim (k/v projections)": cfg.n_kv_heads * hd,
        "d_ff (mlp wi/wo)": cfg.d_ff,
        "vocab (embed/unembed)": cfg.vocab,
    }
    bad = {name: d for name, d in dims.items() if d % m}
    if bad:
        usable = [k for k in range(1, m + 1)
                  if all(d % k == 0 for d in dims.values())]
        lines = ", ".join(f"{name}={d}" for name, d in bad.items())
        raise ValueError(
            f"model mesh axis of {m} devices does not divide {lines} for "
            f"arch {getattr(model_cfg, 'arch_id', type(cfg).__name__)!r}; "
            f"usable {axis!r} sizes here: {usable} (pick one, or drop the "
            f"model axis)")
    return m


def validate_client_mesh(mesh, clients_per_round: int,
                         axis: str = CLIENT_AXIS) -> int:
    """Check that the mesh can shard ``clients_per_round``; returns the
    shard count."""
    axes = mesh_axes(mesh)
    if axis not in axes:
        raise ValueError(
            f"mesh axes {tuple(axes)} have no {axis!r} axis; build one with "
            f"repro_torch.launch.mesh.make_client_mesh()")
    n = axes[axis]
    if clients_per_round % n != 0:
        raise ValueError(
            f"clients_per_round={clients_per_round} must divide evenly over "
            f"the {n}-device {axis!r} mesh axis")
    return n


def client_ctx(mesh, clients_per_round: int,
               axis: str = CLIENT_AXIS) -> ShardCtx:
    """The context of ``mesh``'s client axis, validated: a
    :class:`ModelShardCtx` where another axis is larger than 1 (a composed
    clients x data x model mesh), else a :class:`ShardCtx`."""
    n = validate_client_mesh(mesh, clients_per_round, axis)
    if any(k > 1 for a, k in mesh_axes(mesh).items() if a != axis):
        return ModelShardCtx(mesh, axis)
    return ShardCtx(mesh.get_group(axis), n)


def shard_round(round_impl: Callable, mesh, clients_per_round: int,
                axis: str = CLIENT_AXIS) -> Callable:
    """Bind ``_round_impl(state, key, ctx)`` to ``mesh``'s client axis
    (composed with a model axis, :class:`ModelShardCtx`): a drop-in
    ``(state, key) -> (state, metrics)`` that every rank of the mesh calls
    with the same state and key, and that returns the same state and
    metrics on every rank.  The context is the function's ``ctx``."""
    ctx = client_ctx(mesh, clients_per_round, axis)

    def run(state, key):
        return round_impl(state, key, ctx=ctx)

    run.ctx = ctx
    return run


def usable_shard_counts(clients_per_round: int,
                        max_devices: Optional[int] = None) -> Sequence[int]:
    """Divisors of ``clients_per_round`` up to the world size (or, with no
    process group, the number of cards), ascending."""
    if max_devices is None:
        max_devices = (dist.get_world_size() if dist.is_initialized()
                       else torch.cuda.device_count())
    cap = max(1, max_devices)
    return [d for d in range(1, min(clients_per_round, cap) + 1)
            if clients_per_round % d == 0]
