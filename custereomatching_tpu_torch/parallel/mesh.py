"""Device-mesh construction for the sharded pipeline.

The counterpart of ``custereomatching_tpu/parallel/mesh.py``.  The mesh
is a ``torch.distributed`` ``DeviceMesh`` over the initialised world, one
rank a device, with two named dimensions:

* ``data``: stereo frame pairs (batch / video frames), pure data
  parallelism, no communication in the forward pass;
* ``space``: image rows (H), spatial tiling with a ``kernel_size//2``-row
  halo exchange between neighbouring ranks (:mod:`.halo`).

With ``torchrun`` on one host, ``space`` groups are consecutive ranks, so
the halo exchange rides NVLink; ``data`` only communicates for the loss.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from custereomatching_tpu_torch.config import MeshConfig
from custereomatching_tpu_torch.parallel.multihost import world_size


def make_mesh(config: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, space)`` ``DeviceMesh`` over the first
    ``config.num_devices`` ranks of the initialised world.

    ``device_type`` is ``"cuda"`` (NCCL) unless the caller asks for
    ``"cpu"`` (gloo).  Every rank of the world calls this; raises
    ``ValueError`` when the world has fewer ranks than the mesh needs.
    """
    n = config.num_devices
    have = world_size()
    if have < n:
        raise ValueError(
            f"mesh {config.shape} needs {n} devices, have {have}")
    ranks = torch.arange(n, dtype=torch.int64).reshape(config.shape)
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=tuple(config.axis_names))


def default_mesh_config(n_devices: int) -> MeshConfig:
    """Pick a reasonable (data, space) factorization for ``n_devices``.

    Prefers a 2-way spatial split (enough to exercise halo exchange)
    with the remainder on the batch axis; falls back to pure data
    parallelism for odd device counts.
    """
    space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return MeshConfig(data=n_devices // space, space=space)


__all__ = ["default_mesh_config", "make_mesh"]
