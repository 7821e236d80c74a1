"""Device meshes over the initialised process group, and their abstract
form.

Counterpart of ``repro.launch.mesh``.  A mesh is a ``torch.distributed.
device_mesh.DeviceMesh`` over ranks ``0 .. pods * dp * tp - 1`` of the
world, with dim names ``("data", "model")`` or ``("pod", "data",
"model")``, major to minor as the reference's ``jax.make_mesh`` lays out
its devices.  Every rank of the world calls :func:`make_mesh` (creating a
mesh makes one process group per mesh dim, a collective of the world);
ranks past the mesh's last get a mesh they are not part of.
:class:`AbstractMesh` is the counterpart of ``jax.sharding.AbstractMesh``:
names and sizes without processes, which the rules in ``launch/
shardings.py`` accept as well, so that they can be read at production sizes
on one process.  Importing this module initialises nothing.

The dry run (``launch.dryrun``) builds the production mesh over a fake
world (``launch.world.fake_world``) with ``device_type="cpu"`` and places
``meta`` local tensors on it: ``DTensor.from_local`` takes them, and
sharding propagation runs their ops (checked with torch 2.13).  A
``"meta"`` mesh builds, but sharding propagation fails on its ops (it
asks for a device module of that type); ``"cpu"`` asks nothing of a
card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

TP_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class AbstractMesh:
    """Mesh dim names and sizes, major to minor, without processes."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


Mesh = Union[AbstractMesh, "torch.distributed.device_mesh.DeviceMesh"]


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's dim names, major to minor."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _layout(dp: int, tp: int, pods: int) -> AbstractMesh:
    if pods > 1:
        return AbstractMesh((pods, dp, tp), POD_AXES)
    return AbstractMesh((dp, tp), TP_AXES)


def _mk(layout: AbstractMesh, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {layout.shape} mesh needs {layout.size} ranks, and no process "
            "group is initialised (world size 1 without one)")
    world = dist.get_world_size()
    if layout.size > world:
        raise RuntimeError(
            f"a {layout.shape} mesh needs {layout.size} ranks; the world "
            f"has {world}")
    ranks = torch.arange(layout.size).reshape(layout.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=layout.axis_names)


def make_mesh(dp: int, tp: int, pods: int = 1, *,
              device_type: str = "cuda"):
    """Elastic-runtime mesh: the DP degree is a runtime parameter.  Raises,
    naming the world size, without a process group or with too few
    ranks."""
    return _mk(_layout(dp, tp, pods), device_type)


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"``: a
    world of exactly 256 or 512 ranks; raises otherwise."""
    import torch.distributed as dist
    layout = _layout(16, 16, 2 if multi_pod else 1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != layout.size:
        raise RuntimeError(f"the production mesh {layout.shape} needs a "
                           f"world of {layout.size} ranks; it has {world}")
    return _mk(layout, device_type)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh: Mesh) -> int:
    shape = mesh_shape(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= shape[a]
    return out
