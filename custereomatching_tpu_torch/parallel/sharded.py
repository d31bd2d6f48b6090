"""Mesh-sharded stereo pipeline: batched, spatially tiled, differentiable.

The counterpart of ``custereomatching_tpu/parallel/sharded.py``:

* frames shard over mesh dimension ``data`` (pure data parallelism);
* image rows shard over mesh dimension ``space``, with a
  ``kernel_size//2``-row halo exchange between neighbours
  (:func:`..parallel.halo.halo_exchange`);
* the cost volume never exists globally: each rank holds its
  ``[B/data, H/space, W, L]`` block, and the disparity head is
  elementwise over the sharded axes.

Arrays are ``DTensor``s, whose placements are what JAX's
``PartitionSpec``s are: ``(Shard(0), Shard(1))`` puts the batch axis over
``data`` and the rows over ``space``.  Each path takes the rank's block
(``to_local``), halo-extends it, runs the port's single-device op on the
extended block (the kernels on CUDA tensors, their plain versions on CPU
tensors), crops the halo rows and wraps the block again (``from_local``);
both steps are differentiable, so gradients flow back through the
transposed halo exchange to the rank that owns each row.

The sharded result equals the single-device one: the halo exchange
delivers exactly the rows a window reads, and zeros at true borders.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.ops import cost_volume
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    extract_disparity,
)
from custereomatching_tpu_torch.parallel.halo import halo_exchange

# Canonical placements of the pipeline's arrays over the (data, space) mesh.
IMAGE_SPEC = (Shard(0), Shard(1))    # [B, H, W]
VOLUME_SPEC = (Shard(0), Shard(1))   # [B, H, W, L]
MAP_SPEC = (Shard(0), Shard(1))      # [B, H, W] disparity / mask


class Sharding(NamedTuple):
    """A mesh and the placements of an array on it (JAX's
    ``NamedSharding``)."""

    mesh: DeviceMesh
    placements: Tuple


def image_sharding(mesh: DeviceMesh) -> Sharding:
    """Sharding of ``[B, H, W]`` image batches on ``mesh``."""
    return Sharding(mesh, IMAGE_SPEC)


def volume_sharding(mesh: DeviceMesh) -> Sharding:
    """Sharding of ``[B, H, W, L]`` cost volumes on ``mesh``."""
    return Sharding(mesh, VOLUME_SPEC)


def shard_batch(batch, mesh: DeviceMesh):
    """Distribute a tuple (or one) of ``[B, H, W]`` tensors with the
    pipeline's placements.  Every rank passes the full tensors (rank 0's
    values are scattered); B must divide by ``data`` and H by ``space``."""
    if isinstance(batch, torch.Tensor):
        return _as_dtensor(batch, mesh)
    return type(batch)(_as_dtensor(x, mesh) for x in batch)


def _as_dtensor(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    if isinstance(x, DTensor):
        if tuple(x.placements) != IMAGE_SPEC:
            x = x.redistribute(mesh, IMAGE_SPEC)
        return x
    B, H = x.shape[0], x.shape[1]
    data, space = mesh.size(0), mesh.size(1)
    if B % data or H % space:
        raise ValueError(
            f"[B, H] = [{B}, {H}] must divide by the mesh (data, space) = "
            f"({data}, {space})")
    return distribute_tensor(x, mesh, IMAGE_SPEC)


def _halo(config: StereoConfig, mesh: DeviceMesh) -> int:
    # One row shard needs no halo round trip: its halo would be the zero
    # padding the op applies itself.
    return config.pad if mesh.size(1) > 1 else 0


def _extended(camera, projector, config: StereoConfig, mesh: DeviceMesh):
    """The rank's halo-extended blocks and the halo."""
    halo = _halo(config, mesh)
    group = mesh.get_group(1)
    cam = _as_dtensor(camera, mesh).to_local()
    proj = _as_dtensor(projector, mesh).to_local()
    if not halo:
        return cam, proj, halo
    # Both images in one exchange: one round of sends for the pair.
    pair = halo_exchange(torch.stack((cam, proj)), halo, group, axis=2)
    return (*pair.unbind(0), halo)


def _crop(x: torch.Tensor, halo: int) -> torch.Tensor:
    """Rows of the block's own windows: those centred in halo rows belong
    to the neighbour."""
    return x[:, halo:x.shape[1] - halo] if halo else x


def local_cost_volume(cam_e: torch.Tensor, proj_e: torch.Tensor,
                      config: StereoConfig, halo: int) -> torch.Tensor:
    """Per-shard volume: the single-device op on halo-extended
    ``[B_local, H_local + 2*halo, W]`` blocks (K1 banded, K8 all-pairs on
    CUDA tensors, their plain versions on CPU tensors), halo rows
    cropped."""
    return _crop(cost_volume(cam_e, proj_e, config), halo)


def sharded_cost_volume(camera, projector, config: StereoConfig,
                        mesh: DeviceMesh) -> DTensor:
    """Batched ZNCC cost volume, sharded over ``(data, space)``.

    Args:
      camera, projector: ``[B, H, W]`` frames, ``DTensor``s with
        :data:`IMAGE_SPEC` (:func:`shard_batch`) or plain tensors, which
        are distributed (then no gradient reaches them).  B divides by
        ``data``, H by ``space`` with ``H/space >= kernel_size//2``.
      config: the op's configuration.
      mesh: a ``(data, space)`` mesh from :func:`..parallel.mesh.make_mesh`.

    Returns:
      The ``[B, H, W, L]`` volume as a ``DTensor`` with
      :data:`VOLUME_SPEC`.  Differentiable in the camera (and with
      ``grad_projector`` the projector): each rank's VJP (K2, K7) runs on
      its block and halo-row gradients return to their owner.
    """
    cam_e, proj_e, halo = _extended(camera, projector, config, mesh)
    return DTensor.from_local(local_cost_volume(cam_e, proj_e, config, halo),
                              mesh, VOLUME_SPEC)


def sharded_disparity(cost_volume: DTensor, config: StereoConfig
                      ) -> DisparityResult:
    """The plain disparity head on each rank's block of a sharded volume:
    its reductions run along the unsharded last axis, so it needs no
    collective.  Returns ``DTensor`` maps with :data:`MAP_SPEC`."""
    d = extract_disparity(cost_volume.to_local(), config.num_disparities,
                          config.cost_threshold, config.softargmax_beta)
    mesh = cost_volume.device_mesh
    return DisparityResult(*(DTensor.from_local(m, mesh, MAP_SPEC)
                             for m in d))


def local_disparity_maps(cam_e: torch.Tensor, proj_e: torch.Tensor,
                         config: StereoConfig, halo: int,
                         trainable: bool = False) -> PipelineMaps:
    """Per-shard fused pipeline on halo-extended blocks, halo rows of the
    maps cropped: K3 (or, ``trainable``, K3w + K4) on CUDA tensors, at the
    config's tiles (``pipeline_blocks``, ``trainable_bwd_block_rows``),
    their plain versions on CPU tensors."""
    c = config
    cuda = c.resolved_backend(cam_e.device) == "cuda"
    args = (cam_e, proj_e, c.num_disparities, c.kernel_size, c.epsilon,
            c.softargmax_beta, c.cost_threshold)
    tile_rows, planes = c.pipeline_tile()
    if trainable and cuda:
        maps = stereo_pipeline_trainable(*args, tile_rows=tile_rows,
                                         planes=planes,
                                         bwd_tile_rows=c.bwd_tile_rows())
    elif trainable:
        maps = stereo_pipeline_trainable_reference(*args)
    elif cuda:
        maps = stereo_pipeline_cuda(*args, tile_rows, planes)
    else:
        maps = stereo_pipeline_reference(*args)
    return PipelineMaps(*(_crop(m, halo) for m in maps))


def sharded_disparity_maps(camera, projector, config: StereoConfig,
                           mesh: DeviceMesh, *,
                           trainable: bool = False) -> PipelineMaps:
    """Fused volume-free disparity pipeline, sharded over ``(data,
    space)``: four ``DTensor`` maps with :data:`MAP_SPEC`.

    ``trainable=True`` runs the differentiable pipeline (camera gradients
    through ``soft_disparity`` and ``confidence``; halo-row gradients
    return to their owner).  Banded only, and on a kernel backend
    (``auto`` or ``cuda``; ``auto`` runs the plain versions on CPU
    tensors), as the JAX package's needs a Pallas backend.
    """
    if config.num_disparities is None:
        raise ValueError("fused sharded pipeline requires banded mode")
    if config.backend == "torch":
        raise ValueError(
            "fused sharded pipeline requires a kernel backend; use "
            "sharded_cost_volume + the plain head instead")
    cam_e, proj_e, halo = _extended(camera, projector, config, mesh)
    maps = local_disparity_maps(cam_e, proj_e, config, halo, trainable)
    return PipelineMaps(*(DTensor.from_local(m, mesh, MAP_SPEC)
                          for m in maps))


__all__ = ["IMAGE_SPEC", "MAP_SPEC", "VOLUME_SPEC", "Sharding",
           "image_sharding", "local_cost_volume", "local_disparity_maps",
           "shard_batch", "sharded_cost_volume", "sharded_disparity",
           "sharded_disparity_maps", "volume_sharding"]
