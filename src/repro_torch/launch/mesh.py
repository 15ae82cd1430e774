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


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's TPU production mesh (16 x 16 a pod) belongs to the
    dry run, which is not ported."""
    raise not_ported("make_production_mesh (the dry run's meshes)")


def make_host_mesh(device: str = "cpu") -> DeviceMesh:
    """The degenerate 1 x 1 ``("data", "model")`` mesh of this rank."""
    _require_group("make_host_mesh")
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


def make_client_mesh(n_shards: int | None = None, *, data: int = 1,
                     model: int = 1, device: str = "cuda") -> DeviceMesh:
    """The 1-D ``("clients",)`` mesh whose ranks split the sampled clients
    of a federated round (DESIGN.md §6; consumed by
    ``RoundEngine.use_mesh`` and ``server.run_federated(mesh=...)``).

    ``n_shards`` defaults to the world size; a smaller mesh holds ranks
    ``0 .. n_shards - 1`` (every rank calls this, and a rank outside the
    mesh cannot use it).  A ``data`` or ``model`` axis larger than 1 (the
    composed clients x model regime) is the next slice and raises.
    """
    if data != 1 or model != 1:
        raise not_ported(f"a client mesh composed with data={data}, "
                         f"model={model} (ModelShardCtx)")
    _require_group("make_client_mesh")
    if n_shards is None:
        n_shards = dist.get_world_size()
    if not 1 <= n_shards <= dist.get_world_size():
        raise ValueError(f"n_shards must be in [1, world size "
                         f"{dist.get_world_size()}], got {n_shards}")
    return init_device_mesh(device, (n_shards,), mesh_dim_names=("clients",))
