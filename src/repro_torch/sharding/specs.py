"""Parameter sharding rules, the mesh-free part of
``repro.sharding.specs``.

Logical scheme: ``model`` is tensor parallelism (attention heads, d_ff,
vocab, experts); ``data`` is batch parallelism and FSDP-style weight
sharding (the weights' d_model-sized dims); ``pod``, where present, joins
``data``.  Rules match on the parameter path (the joined dict keys, the
same paths as the reference's trees).  A spec is a tuple with one entry a
dimension: an axis name, a tuple of axis names, or ``None``.

The path rules (:func:`param_spec`, :func:`_sanitize`,
:func:`model_dim_index`, :func:`batch_axis`) read a mesh's axis names and
sizes and nothing else (a ``DeviceMesh``, or any object with
``mesh_dim_names`` and ``shape``).  :func:`param_shardings`,
:func:`batch_spec`, :func:`cache_spec` and :func:`state_sharding` turn
them into ``torch.distributed.tensor`` placements: one ``Shard(dim)`` or
``Replicate()`` a mesh dimension, in the mesh's order, the argument
``DTensor.from_local`` and ``distribute_tensor`` take.  The model axis's
wire (``core/distributed.py``) reads :func:`model_dim_index`, which names
the dimension these placements shard over ``model``.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree as tree_util

Spec = Tuple[Any, ...]
PyTree = Any


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape)))


def _fsdp_axis(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else "data"


def _fsdp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return axes["data"] * axes.get("pod", 1)


def batch_axis(mesh, dim_size: int):
    """The fsdp axis for a batch dim, or None when it doesn't divide (e.g.
    the batch-1 long-context decode)."""
    return _fsdp_axis(mesh) if dim_size % _fsdp_size(mesh) == 0 else None


def path_str(keys) -> str:
    """A leaf's path as the rules read it: its keys (as
    ``repro_torch.tree.leaves_with_paths`` gives them) joined by "/"."""
    return keys if isinstance(keys, str) else "/".join(str(k) for k in keys)


def param_spec(path: str, shape: tuple, mesh,
               expert_over_model: bool) -> Spec:
    """The spec of one parameter, by path pattern and rank."""
    fsdp = _fsdp_axis(mesh)
    ndim = len(shape)

    # ---- MoE expert tensors (E, D, F) / (E, F, D) ----------------------- #
    if re.search(r"moe/(wi|wg)/kernel$", path):
        return ("model", fsdp, None) if expert_over_model \
            else (None, fsdp, "model")
    if re.search(r"moe/wo/kernel$", path):
        return ("model", None, fsdp) if expert_over_model \
            else (None, "model", fsdp)
    if re.search(r"moe/router/kernel$", path):
        return (fsdp, None)

    # ---- embeddings ------------------------------------------------------ #
    if path.endswith("embed/embedding"):
        return ("model", fsdp)
    if re.search(r"unembed/kernel$", path):
        return (fsdp, "model")

    # ---- attention ------------------------------------------------------- #
    if re.search(r"(^|/)(q|k|v|self_attn/q|self_attn/k|self_attn/v"
                 r"|cross_attn/q|cross_attn/k|cross_attn/v)/kernel$", path):
        return (fsdp, "model")
    if re.search(r"(^|/)(o|self_attn/o|cross_attn/o)/kernel$", path):
        return ("model", fsdp)
    if re.search(r"(^|/)(q|k|v)/bias$", path):
        return ("model",)

    # ---- dense / shared MLP ---------------------------------------------- #
    if re.search(r"(mlp|shared_mlp)/(wi|wg)/kernel$", path):
        return (fsdp, "model")
    if re.search(r"(mlp|shared_mlp)/wo/kernel$", path):
        return ("model", fsdp)

    # ---- RG-LRU ------------------------------------------------------------ #
    if re.search(r"rglru/(wx|wy)/kernel$", path):
        return (fsdp, "model")
    if re.search(r"rglru/wo/kernel$", path):
        return ("model", fsdp)
    if re.search(r"rglru/(gate_a|gate_x)/kernel$", path):
        return (fsdp, "model")
    if re.search(r"rglru/(gate_a|gate_x)/bias$", path) or \
            path.endswith("rglru/lam"):
        return ("model",)
    if re.search(r"rglru/conv/kernel$", path):
        return (None, "model")

    # ---- RWKV6 -------------------------------------------------------------- #
    if re.search(r"rwkv/(wr|wk|wv|wg|cm_r|cm_k)/kernel$", path):
        return (fsdp, "model")
    if re.search(r"rwkv/(wo|cm_v)/kernel$", path):
        return ("model", fsdp)
    if re.search(r"rwkv/wa/kernel$", path):
        return (fsdp, None)
    if re.search(r"rwkv/wb/kernel$", path):
        return (None, "model")
    if path.endswith("rwkv/w0"):
        return ("model",)
    if path.endswith("rwkv/mu") or path.endswith("rwkv/cm_mu"):
        return (None, "model")

    # ---- everything else (norms, scalars, small) -> replicated ----------- #
    return (None,) * ndim


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = mesh_axes(mesh)
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= axes[a]
        return n
    return axes[entry]


def _sanitize(spec: Spec, shape: tuple, mesh) -> Spec:
    """Drop axis assignments whose dim doesn't divide the axis size (an
    uneven placement, e.g. seamless' 256206 vocab over 16)."""
    return tuple(None if entry is not None
                 and shape[dim] % _axis_size(mesh, entry) != 0 else entry
                 for dim, entry in enumerate(spec))


def model_dim_index(path, shape: tuple, model_shards: int, *,
                    expert_over_model: bool = False) -> Optional[int]:
    """The index of the dimension :func:`param_spec` puts on ``model``, or
    None: for replicated leaves, and for leaves whose model dim does not
    divide ``model_shards`` (where :func:`_sanitize` strips the axis from
    the placement, so the wire layout and the placement agree)."""
    spec = param_spec(path_str(path), shape, _RULE_MESH, expert_over_model)
    for dim, entry in enumerate(spec):
        if entry == "model":
            return dim if shape[dim] % int(model_shards) == 0 else None
    return None


class _RuleMesh:
    """A mesh stand-in for :func:`param_spec`, which reads only the axis
    names (for the pod check): the path rules without a device mesh."""

    mesh_dim_names = ("data", "model")
    shape = (1, 1)


_RULE_MESH = _RuleMesh()


def placements(spec: Spec, mesh) -> tuple:
    """A spec as ``torch.distributed.tensor`` placements, one a mesh
    dimension in the mesh's order: ``Shard(d)`` where tensor dimension
    ``d``'s entry names that axis (alone or in a tuple), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names or ():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(params_shape: PyTree, mesh, *,
                    n_experts: Optional[int] = None) -> PyTree:
    """The tree of each parameter's placements (``repro.sharding.specs.
    param_shardings``): :func:`param_spec` after :func:`_sanitize`.
    ``params_shape`` holds tensors (meta ones do).  The reference's
    ``seq_parallel`` prefill scheme belongs to the dry run, not ported."""
    model_size = mesh_axes(mesh)["model"]
    expert_over_model = bool(n_experts) and n_experts % model_size == 0

    def one(keys, leaf):
        shape = tuple(leaf.shape)
        spec = param_spec(path_str(keys), shape, mesh, expert_over_model)
        return placements(_sanitize(spec, shape, mesh), mesh)

    pairs = tree_util.leaves_with_paths(params_shape)
    return tree_util.unflatten(params_shape, [one(k, l) for k, l in pairs])


def batch_spec(mesh) -> tuple:
    """Tokens and labels: the batch over (pod, data)."""
    return placements((_fsdp_axis(mesh),), mesh)


def cache_spec(mesh, kv_heads: int, cache_len: int) -> tuple:
    """KV caches ``(B, H, S, Dh)``: the batch over (pod, data), the cache
    length over ``model``."""
    return placements((_fsdp_axis(mesh), None, "model", None), mesh)


def state_sharding(state_shape: PyTree, mesh) -> PyTree:
    """The decode state's placements (KV caches and recurrent states):
    a KV cache's length over ``model`` where it is long and divides, every
    leading batch dimension over (pod, data) where it divides, scalars
    (the cache ``length``) replicated."""
    model = mesh_axes(mesh)["model"]

    def one(keys, leaf):
        p = path_str(keys)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if p.endswith("length") or nd == 0:
            return placements((), mesh)
        b = batch_axis(mesh, shape[0])
        if nd == 4 and (p.endswith("/k") or p.endswith("/v")):
            long = shape[2] >= 4 * model and shape[2] % model == 0
            return placements((b, None, "model" if long else None, None),
                              mesh)
        return placements((b,) + (None,) * (nd - 1), mesh)

    pairs = tree_util.leaves_with_paths(state_shape)
    return tree_util.unflatten(state_shape, [one(k, l) for k, l in pairs])
