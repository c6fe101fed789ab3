"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``reductive_tpu.parallel.mesh``.  JAX lays one controller's
devices out in a ``Mesh``; here there is one process a rank (a card), and a
:class:`torch.distributed.device_mesh.DeviceMesh` names the ranks' axes.
The sharded entries read an axis's process group, size and this rank's
place on it from the mesh (:func:`axis_group`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "mesh_shape", "axis_group", "mesh_device"]


def mesh_shape(
    shape: Optional[Tuple[int, ...]], axis_names: Sequence[str], n: int
) -> Tuple[int, ...]:
    """The mesh shape over ``n`` ranks, by the JAX package's rules: ``None``
    is ``(n,)`` for one axis; one ``-1`` takes the ranks the other axes
    leave; the product must be ``n`` and there is one size an axis name."""
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape is required for multi-axis meshes")
    shape = tuple(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape = tuple(n // known if s == -1 else s for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names length mismatch")
    return shape


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> DeviceMesh:
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over every rank
    of the default process group (set up first by
    :func:`reductive_tpu_torch.parallel.initialize_distributed`).

    By default the ranks form a 1-D ``data`` mesh.  Pass e.g.
    ``shape=(4, 2), axis_names=("data", "model")`` for a 2-D layout where
    instances shard 4 ways and subquantizers 2 ways; ``shape`` may contain
    one ``-1``, which takes the remaining ranks.  ``devices`` is the ranks'
    device type: ``None`` means ``"cuda"`` (each rank's current card),
    ``"cpu"`` a mesh of processes on the host.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "reductive_tpu_torch.parallel.initialize_distributed() first"
        )
    axis_names = tuple(axis_names)
    shape = mesh_shape(shape, axis_names, dist.get_world_size())
    device_type = "cuda" if devices is None else torch.device(devices).type
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def axis_group(mesh: DeviceMesh, axis: str) -> Tuple[dist.ProcessGroup, int, int]:
    """``(group, size, index)``: the process group of the ranks that share
    this rank's place on every other axis, their number, and this rank's
    place among them."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: {mesh.mesh_dim_names})")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card on a ``"cuda"`` mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
