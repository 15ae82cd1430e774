"""Device meshes on ``torch.distributed`` (the port of
``repro.launch.mesh``).

Functions, never module-level constants, so importing this module touches
no process group.  Each builds a ``torch.distributed.device_mesh.
DeviceMesh`` over the default process group, which the caller initialises
first (``torch.distributed.init_process_group`` with its own address,
world size and rank: ``tcp://localhost:<port>`` or a ``FileStore``).  The
device is explicit and defaults to the card; the CPU tests pass
``device="cpu"`` under gloo.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import not_ported


def _require_group(what: str) -> None:
    if not dist.is_initialized():
        raise ValueError(
            f"{what} needs torch.distributed initialised first: call "
            f"init_process_group(backend, init_method='tcp://localhost:"
            f"<port>' or store=FileStore(...), world_size=..., rank=...)")


def _outer_size(what: str, name: str, outer: int | None, data: int,
                model: int) -> int:
    """The outermost axis's size of a ``(outer, data, model)`` mesh over
    ranks ``0 ..``, checked against the world size (by default ``world
    size // (data x model)``)."""
    _require_group(what)
    world = dist.get_world_size()
    if data < 1 or model < 1:
        raise ValueError(f"data and model must be >= 1, got data={data}, "
                         f"model={model}")
    if outer is None:
        outer = max(1, world // (data * model))
    if not 1 <= outer * data * model <= world:
        raise ValueError(f"{name} x data x model must be in [1, world size "
                         f"{world}], got {outer} x {data} x {model}")
    return outer


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's TPU production mesh (16 x 16 a pod) belongs to the
    dry run, which is not ported."""
    raise not_ported("make_production_mesh (the dry run's meshes)")


def make_host_mesh(device: str = "cpu") -> DeviceMesh:
    """The degenerate 1 x 1 ``("data", "model")`` mesh of this rank."""
    _require_group("make_host_mesh")
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


def make_client_mesh(n_shards: int | None = None, *, data: int = 1,
                     model: int = 1, config=None,
                     device: str = "cuda") -> DeviceMesh:
    """The mesh whose ``clients`` ranks split the sampled clients of a
    federated round (DESIGN.md §6; consumed by ``RoundEngine.use_mesh``
    and ``server.run_federated(mesh=...)``).

    With ``data`` and ``model`` at 1 this is the 1-D ``("clients",)`` mesh
    of ``n_shards`` ranks.  Otherwise it is the ``("clients", "data",
    "model")`` mesh of ``n_shards x data x model`` ranks, clients
    outermost and row-major over the ranks, so each clients rank holds a
    contiguous data x model block (DESIGN.md §9: the shard-local wire over
    ``model``).  ``n_shards`` defaults to ``world size // (data x
    model)``; the mesh holds ranks ``0 ..`` of its size (every rank calls
    this, and a rank outside the mesh cannot use it).  ``config`` (an
    ``ArchSpec`` or ``ModelConfig``) with ``model > 1`` checks that the
    model axis divides its sharded dimensions
    (:func:`repro_torch.core.distributed.validate_model_axis`).
    """
    n_shards = _outer_size("make_client_mesh", "n_shards", n_shards, data,
                           model)
    if data == 1 and model == 1:
        return init_device_mesh(device, (n_shards,),
                                mesh_dim_names=("clients",))
    mesh = init_device_mesh(device, (n_shards, data, model),
                            mesh_dim_names=("clients", "data", "model"))
    if config is not None and model > 1:
        from repro_torch.core.distributed import validate_model_axis
        validate_model_axis(mesh, config)
    return mesh


def make_pod_mesh(pods: int | None = None, *, data: int = 1, model: int = 1,
                  device: str = "cuda") -> DeviceMesh:
    """The ``("pod", "data", "model")`` mesh of ``pods x data x model``
    ranks whose pods are the federated clients of
    ``launch/fed_train.py``'s pod round (DESIGN.md §2), pods outermost and
    row-major over ranks ``0 ..`` of its size.  ``pods`` defaults to
    ``world size // (data x model)``.  Every rank calls this (a new group
    is collective), and a rank outside the mesh cannot use it."""
    pods = _outer_size("make_pod_mesh", "pods", pods, data, model)
    return init_device_mesh(device, (pods, data, model),
                            mesh_dim_names=("pod", "data", "model"))
