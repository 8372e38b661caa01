"""Meshes, and the process group under them.

``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` on a
process group that is already up (``start_group``, or the caller's own).
The production meshes, 16x16 = 256 devices a pod and 2x16x16 = 512 across
two pods, are data (``MeshShape``): no one machine builds 256 ranks, and
the dry-run census needs only their axis names and sizes. The 'pod' axis
is the low-bandwidth dimension and carries only the data-parallel
gradient all-reduce by default.

Importing this module touches no process group and no device.
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MeshShape:
    """A mesh as data: its dims and axis names, no devices. ``shape`` maps
    axis name to size, as the sharding rules read a mesh."""
    dims: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 over ('data', 'model'), or 2x16x16 over ('pod', 'data',
    'model') with ``multi_pod``."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def start_group(directory: str, rank: int, world_size: int, *,
                device="cuda", timeout_s: float = 120.0) -> None:
    """Start this process's rank of a ``world_size`` process group whose
    ranks meet in a ``FileStore`` under ``directory`` (a path every rank
    can reach; no TCP port is opened): NCCL on the card (rank r on card
    r mod the card count), gloo on the CPU. Every collective of the group
    fails after ``timeout_s`` seconds rather than hang."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but torch sees no "
                               "CUDA device")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    store = dist.FileStore(os.path.join(directory, "group_store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: tuple, axes: tuple, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the axis names ``axes`` on the
    process group that is up, whose world size must be prod(shape)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group that is up "
                           "(launch.mesh.start_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device="cuda"):
    """The 1-device mesh of a one-rank group, with the single pod's axis
    names: (1, 1) over ('data', 'model')."""
    return make_mesh((1, 1), ("data", "model"), device=device)
