"""Parameter sharding rules, the mesh-free part of
``repro.sharding.specs``.

Logical scheme: ``model`` is tensor parallelism (attention heads, d_ff,
vocab, experts); ``data`` is batch parallelism and FSDP-style weight
sharding (the weights' d_model-sized dims); ``pod``, where present, joins
``data``.  Rules match on the parameter path (the joined dict keys, the
same paths as the reference's trees).  A spec is a tuple with one entry a
dimension: an axis name, a tuple of axis names, or ``None``.

Only the path rules are here: :func:`param_spec`, :func:`_sanitize`,
:func:`model_dim_index` and :func:`batch_axis`, which read a mesh's axis
names and sizes and nothing else (a ``DeviceMesh``, or any object with
``mesh_dim_names`` and ``shape``).  Turning them into
``torch.distributed.tensor`` placements (``param_shardings``,
``state_sharding``) comes with the model axis.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

Spec = Tuple[Any, ...]


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
