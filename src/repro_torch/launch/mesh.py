"""Mesh construction over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

Single pod: (data=16, model=16) == 256 ranks. Multi-pod: (pod=2, data=16,
model=16) == 512 ranks; the ``pod`` axis is an outer data-parallel axis.
A production mesh needs a process group of that many ranks; the dry-run
(``launch/dryrun.py``) opens a ``fake`` one, which computes nothing. A
local mesh spans the ranks of a real group, one card each (or the CPU).

Defined as functions: importing this module touches no process group.
"""
from __future__ import annotations

from repro_torch.device import resolve_device

__all__ = ["PRODUCTION_SHAPES", "mesh_of", "make_production_mesh",
           "make_local_mesh", "batch_axes"]

# axis name -> size of each production mesh, in the mesh's order
PRODUCTION_SHAPES = {
    False: {"data": 16, "model": 16},
    True: {"pod": 2, "data": 16, "model": 16},
}


def mesh_of(shape: dict, device_type: str = "cpu"):
    """A mesh of ``shape`` (axis name -> size, in order) over the first
    ranks of the current process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The 16 x 16 (or 2 x 16 x 16) mesh over a process group of at least
    256 (512) ranks."""
    return mesh_of(PRODUCTION_SHAPES[multi_pod], device_type)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the current process group's data x model
    ranks, on the card unless ``device="cpu"``."""
    return mesh_of({"data": data, "model": model},
                   resolve_device(device).type)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") \
        else tuple(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
