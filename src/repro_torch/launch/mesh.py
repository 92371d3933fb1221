"""Device meshes, the counterpart of ``repro.launch.mesh``: functions, not
module-level constants, so importing this module touches no process
group. Each builds a ``DeviceMesh`` (``init_device_mesh``) over the
default process group, which the caller has initialised
(``torch.distributed.init_process_group``) with one rank a device.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch.distributed as dist

from .. import resolve_device

__all__ = ["make_mesh", "make_production_mesh", "make_serving_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group, whose world size must be the product of
    ``shape``. ``device_type`` None means "cuda" (which raises without a
    card, as ``repro_torch.resolve_device``); tests pass "cpu" (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve_device(device_type).type
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """16x16 = 256 devices a pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_serving_mesh(mesh_axes: Mapping[str, int], device_type: Optional[str] = None):
    """The ``(data, model)`` mesh that the reference's ``plan_serving``
    suggests ({"data": dp, "model": tp})."""
    shape = (int(mesh_axes["data"]), int(mesh_axes["model"]))
    return make_mesh(shape, ("data", "model"), device_type)
