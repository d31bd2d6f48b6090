"""Parallel layer: device meshes, halo exchange, the sharded pipeline and
disparity-range pipeline stages, on ``torch.distributed`` (NCCL between
cards, gloo between CPU ranks).  The counterpart of
``custereomatching_tpu/parallel``."""

from custereomatching_tpu_torch.parallel.halo import halo_exchange
from custereomatching_tpu_torch.parallel.mesh import (
    default_mesh_config,
    make_mesh,
)
from custereomatching_tpu_torch.parallel.multihost import (
    initialize_multihost,
    make_global_mesh,
    process_local_batch_slice,
    spawn_ranks,
)
from custereomatching_tpu_torch.parallel.pipeline import (
    pipelined_video_maps,
    stage_mesh,
)
from custereomatching_tpu_torch.parallel.sharded import (
    IMAGE_SPEC,
    MAP_SPEC,
    VOLUME_SPEC,
    image_sharding,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
    volume_sharding,
)

__all__ = [k for k in globals() if not k.startswith("_")]
