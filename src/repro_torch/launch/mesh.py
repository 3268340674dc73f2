"""Meshes of the dry-run and the host.  Functions, not module constants, so
importing touches no device state (the counterpart of
``repro.launch.mesh``)."""
from __future__ import annotations

from ..sharding.rules import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes: 16 x 16 over ("data", "model");
    ``multi_pod`` adds a leading 2-pod axis.  A shape only: no device
    stands behind it, so the port's dry-run cells compare one to one with
    the reference's."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh():
    """What this host has: ("data",) over its CUDA devices.  Where a
    process group is up, a ``DeviceMesh`` over them
    (``init_device_mesh``); otherwise their shape."""
    import torch
    import torch.distributed as dist
    n = torch.cuda.device_count()
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh("cuda", (n,), mesh_dim_names=("data",))
    return MeshShape((n,), ("data",))
