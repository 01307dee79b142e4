"""Meshes of processes: ``repro.launch.mesh`` on ``torch.distributed``.

A mesh names the axes of a grid of ranks, ``("data", "model")`` or
``("pod", "data", "model")``: batch rows over the data-parallel axes
(``pod`` folds into them), expert slots over ``model``, each expert's
FFN width over ``data``.  :func:`make_mesh` builds a
``torch.distributed.device_mesh.DeviceMesh`` over the current world,
ranks in row-major order (rank = data index x model size + model
index), so a mesh axis's process group holds its ranks in coordinate
order.  The production layouts (16 x 16 and 2 x 16 x 16) exist here only
as a :class:`MeshLayout`, a shape and its axis names: the sharding
rules and the capacity reckoning need nothing else.

Functions only: importing this module touches no process-group state.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class MeshLayout(NamedTuple):
    """A mesh's shape and axis names without ranks (the attribute names
    of ``DeviceMesh``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshLayout`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current world
    (its size must be the product of ``shape``), on ``device``'s type:
    ``"cuda"`` (NCCL groups) or ``"cpu"`` (gloo groups).  The default
    process group must exist."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if axes not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"mesh axes {axes}: expected ('data', 'model') or "
                         f"('pod', 'data', 'model')")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} holds {n} ranks, the world "
                         f"{dist.get_world_size()}")
    device_type = str(device).split(":")[0]
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod: 16 x 16 = 256 ranks, ("data", "model").  Multi pod: 2 x
    16 x 16 = 512, ("pod", "data", "model")."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_host_mesh(device: str = "cuda"):
    """(1, world) over the current world: every rank an EP rank."""
    import torch.distributed as dist
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)
