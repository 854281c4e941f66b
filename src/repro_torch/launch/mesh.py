"""Production mesh construction (counterpart of ``repro.launch.mesh``): a
``torch.distributed`` ``DeviceMesh`` over the ranks of an initialized
process group, one rank a mesh position.

Functions, not module-level constants: importing this module touches no
device and no process group.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 ..
    prod(shape) - 1 of the default process group; raises when the world
    is smaller than the mesh, as the reference does when it has fewer
    devices.  Each rank must have set its device first (one card a rank,
    or several ranks on one card under gloo)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have}: start one "
            f"process a mesh position (launch/lda_train.py --backend "
            f"shard_map starts them) with an initialized process group")
    return DeviceMesh(device_type,
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_chip_count(mesh) -> int:
    return int(np.prod(tuple(mesh.shape)))
