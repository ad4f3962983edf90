"""Production mesh construction.

The port's copy of ``repro/launch/mesh.py``.  Single pod: 256 devices as
(data=16, model=16).  Multi-pod: 2 pods x 256 devices as (pod=2, data=16,
model=16); the ``pod`` axis is pure data parallelism (DESIGN.md §5), so
cross-pod traffic is gradient all-reduce only.

Where the port differs: a mesh is a ``torch.distributed`` ``DeviceMesh``
over the default process group, which the caller opens
(``torch.distributed.init_process_group``: NCCL on GPUs, gloo on the CPU,
the fake group under the dry run); nothing here opens one.  A production
mesh on a group of another size raises :class:`MeshError`, where
``jax.make_mesh`` raises without its 256 (512) devices.
``make_abstract_mesh`` is device-free: it needs no process group and
carries only what the sharding rules read.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.models.layers import mesh_axes

__all__ = [
    "MeshError",
    "AbstractMesh",
    "make_production_mesh",
    "make_test_mesh",
    "make_abstract_mesh",
    "data_axes",
    "mesh_axes",
    "MODEL_AXIS",
]

MODEL_AXIS = "model"


class MeshError(RuntimeError):
    """A mesh asked of a process group that does not have its devices."""


class AbstractMesh:
    """Axis names and sizes, no devices: ``.shape`` maps each axis to its
    size (in mesh order), as the reference's ``AbstractMesh`` does."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> AbstractMesh:
    """Device-free mesh for the sharding-rule tables."""
    return AbstractMesh(shape, axes)


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_initialized():
        raise MeshError(f"a {need}-device mesh {dict(zip(axes, shape))} needs a default "
                        "process group; none is initialized")
    world = dist.get_world_size()
    if world != need:
        raise MeshError(f"a {need}-device mesh {dict(zip(axes, shape))} needs a process "
                        f"group of {need} ranks; the default group has world size {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), over the default process group, which must have 256
    (512) ranks (:class:`MeshError` otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, device_type: str = "cpu"):
    """A small mesh over the current process group (world size data x model
    (x pod))."""
    if pod:
        return _device_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _device_mesh((data, model), ("data", "model"), device_type)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh_axes(mesh) if a != MODEL_AXIS)
