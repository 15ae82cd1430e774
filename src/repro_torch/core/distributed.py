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
* ``psum``, ``mean_clients``, ``sum_clients`` — ``all_reduce(SUM)``;
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

``ModelShardCtx`` — the composed clients x model mesh with the
shard-local wire — is the next slice, and raises.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import not_ported
from repro_torch import tree as tree_util
from repro_torch.core.clients import ClientAxisCtx, RoundPlan
from repro_torch.sharding.specs import mesh_axes

PyTree = Any

CLIENT_AXIS = "clients"


def _group_device(group) -> torch.device:
    """The device a group's collectives run on: the current card under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class ShardCtx(ClientAxisCtx):
    """The sampled-client axis split over the ranks of ``group``."""

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
        return t.detach().to(self.device).contiguous()

    def all_clients(self, vec: torch.Tensor) -> torch.Tensor:
        t = self._out(vec)
        full = torch.empty((t.shape[0] * self.n_shards,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(full, t, group=self.group)
        return full.to(vec.device)

    def all_clients_tree(self, tree: PyTree) -> PyTree:
        return tree_util.map(self.all_clients, tree)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        t = self._out(x).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t.to(x.device)

    def psum(self, x):
        return tree_util.map(self._all_reduce, x)

    def mean_clients(self, stacked: PyTree) -> PyTree:
        # the mean of the shards' equal-sized means: at D = 1 this is the
        # unsharded t.mean(0) bit for bit (the sum over one rank is a copy)
        return tree_util.map(
            lambda t: self._all_reduce(t.mean(dim=0)) / self.n_shards,
            stacked)

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


class ModelShardCtx(ClientAxisCtx):
    """The composed clients x model regime (the shard-local wire)."""

    def __init__(self, *args, **kwargs):
        raise not_ported("ModelShardCtx (a mesh with a model or data axis)")


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
    """The :class:`ShardCtx` of ``mesh``'s client axis, validated; a mesh
    with another axis larger than 1 raises (the model axis is the next
    slice)."""
    n = validate_client_mesh(mesh, clients_per_round, axis)
    extra = {a: k for a, k in mesh_axes(mesh).items() if a != axis and k > 1}
    if extra:
        raise not_ported(f"a client mesh composed with {extra} "
                         f"(ModelShardCtx)")
    return ShardCtx(mesh.get_group(axis), n)


def shard_round(round_impl: Callable, mesh, clients_per_round: int,
                axis: str = CLIENT_AXIS) -> Callable:
    """Bind ``_round_impl(state, key, ctx)`` to ``mesh``'s client axis:
    a drop-in ``(state, key) -> (state, metrics)`` that every rank of the
    axis calls with the same state and key, and that returns the same
    state and metrics on every rank."""
    ctx = client_ctx(mesh, clients_per_round, axis)

    def run(state, key):
        return round_impl(state, key, ctx=ctx)

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
