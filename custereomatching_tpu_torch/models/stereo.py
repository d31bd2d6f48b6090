"""Flagship model: the end-to-end structured-light stereo matcher (PyTorch).

The counterpart of ``custereomatching_tpu/models/stereo.py``: image pair,
ZNCC cost volume, confidence mask, hard and soft disparity.  A batch runs
as the kernels' grid batch dimension (one launch for all frames), so the
JAX package's frame stacking along H (``_stack_gap``/``_run_stacked``,
which encode the TPU window-sum read reach) has no counterpart here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.ops import cost_volume
from custereomatching_tpu_torch.ops.consistency import (
    flip_back,
    lr_consistency_mask,
    matched_pair_right,
)
from custereomatching_tpu_torch.ops.cuda_head import extract_disparity_cuda
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
from custereomatching_tpu_torch.parallel.sharded import (
    sharded_cost_volume,
    sharded_disparity,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS, span

# The share of the card's memory that the trainable pipeline's saved cost
# volume may take; past it the volume-free pipeline (K3m + K5) runs.
VOLUME_SHARE = 0.75


def keeps_volume(batch: int, height: int, width: int, num_disparities: int,
                 capacity: int) -> bool:
    """Whether the trainable fused pipeline keeps its cost volume as the
    backward's residual (K3w + K4) for ``[batch, height, width]`` pairs
    over ``num_disparities``: where the volume's ``4 B (D+1) H W`` bytes
    are at most :data:`VOLUME_SHARE` (3/4) of the card's ``capacity``
    bytes.  The quarter left holds the maps, the scratch, the images and
    Adam's state beside it.  KITTI's 4 frames (1.44 GB) keep it; 15
    Middlebury frames at 2880x1988 over 290 planes (99.6 GB) do not."""
    volume = 4 * batch * (num_disparities + 1) * height * width
    return volume <= VOLUME_SHARE * capacity


@functools.lru_cache(maxsize=None)
def card_memory(index: int) -> int:
    """Total memory of the CUDA card ``index`` in bytes, read once (the
    caching allocator's free memory would change the choice from step to
    step)."""
    return torch.cuda.get_device_properties(index).total_memory


class StereoOutput(NamedTuple):
    """Batched model outputs.

    Attributes:
      cost_volume: ``[B, H, W, L]`` ZNCC correlation volume.
      disparity: ``[B, H, W]`` hard disparity, confidence-masked.
      soft_disparity: ``[B, H, W]`` sub-pixel soft-argmax disparity.
      mask: ``[B, H, W]`` confidence mask.
      confidence: ``[B, H, W]`` per-pixel max correlation.
    """

    cost_volume: torch.Tensor
    disparity: torch.Tensor
    soft_disparity: torch.Tensor
    mask: torch.Tensor
    confidence: torch.Tensor


class StereoMatcher(nn.Module):
    """Batched stereo matcher over ``[B, H, W]`` pairs.

    The ``cuda`` backend runs the kernels on CUDA tensors: K1 for a banded
    :meth:`cost_volume`, K2 for its camera gradient and, with
    ``grad_projector``, K7 for its projector gradient; K8 for an all-pairs
    :meth:`cost_volume`, K8b for its camera gradient; K8h for
    :meth:`disparity` over either volume, K8hb for its gradient; K3 for
    :meth:`disparity_maps` (twice for :meth:`disparity_maps_lr`), K3w and
    K4 for :meth:`trainable_disparity_maps`, or K3m and K5 where the saved
    volume would not fit on the card (:func:`keeps_volume`), K3, K3w and
    K3m at the config's ``pipeline_blocks`` tile and K4 at its
    ``trainable_bwd_block_rows``.  The ``torch`` backend runs their plain
    versions.  The model has no parameters: its state is the config.
    """

    def __init__(self, config: StereoConfig = StereoConfig()):
        super().__init__()
        self.config = config

    def _backend(self, camera: torch.Tensor) -> str:
        return self.config.resolved_backend(camera.device)

    # -- volume path --------------------------------------------------------
    def cost_volume_single(self, camera: torch.Tensor,
                           projector: torch.Tensor) -> torch.Tensor:
        """ZNCC cost volume ``[H, W, L]`` of one ``[H, W]`` pair."""
        return self.cost_volume(camera[None], projector[None])[0]

    def cost_volume(self, camera: torch.Tensor,
                    projector: torch.Tensor) -> torch.Tensor:
        """ZNCC cost volume ``[B, H, W, L]`` of a ``[B, H, W]`` batch: L is
        D+1 (banded) or W (all-pairs, ``num_disparities=None``), routed by
        :func:`..ops.cost_volume` (K1 + K2, with ``grad_projector`` K7;
        K8; or the plain ops)."""
        return cost_volume(camera, projector, self.config)

    def disparity(self, cost_volume: torch.Tensor) -> DisparityResult:
        """Batched disparity head over a ``[B, H, W, L]`` volume: K8h, whose
        backward is K8hb, on the ``cuda`` backend; the plain head on
        ``torch``."""
        c = self.config
        head = (extract_disparity_cuda
                if c.resolved_backend(cost_volume.device) == "cuda"
                else extract_disparity)
        return head(cost_volume, c.num_disparities, c.cost_threshold,
                    c.softargmax_beta)

    def forward(self, camera: torch.Tensor,
                projector: torch.Tensor) -> StereoOutput:
        """Full pipeline on a ``[B, H, W]`` batch, differentiable in the
        camera (and the projector with ``grad_projector``)."""
        cv = self.cost_volume(camera, projector)
        d = self.disparity(cv)
        return StereoOutput(cost_volume=cv, disparity=d.disparity,
                            soft_disparity=d.soft_disparity, mask=d.mask,
                            confidence=d.confidence)

    def _volume_maps(self, camera: torch.Tensor,
                     projector: torch.Tensor) -> PipelineMaps:
        out = self(camera, projector)
        return PipelineMaps(disparity=out.disparity,
                            soft_disparity=out.soft_disparity,
                            mask=out.mask, confidence=out.confidence)

    # -- fused inference path -----------------------------------------------
    def disparity_maps(self, camera: torch.Tensor,
                       projector: torch.Tensor) -> PipelineMaps:
        """Batched ``[B, H, W]`` pair to disparity maps, volume-free on the
        ``cuda`` backend (K3).  Inference only.  The fused pipeline is
        banded: all-pairs raises ``ValueError`` on ``cuda`` and takes the
        volume path on ``torch``, as in the JAX package.  The call is the
        span ``custereo.model.disparity_maps``."""
        with span("custereo.model.disparity_maps"):
            c = self.config
            cuda = self._backend(camera) == "cuda"
            if c.num_disparities is None:
                if cuda:
                    raise ValueError("fused pipeline requires banded mode")
                return self._volume_maps(camera, projector)
            args = (camera, projector, c.num_disparities, c.kernel_size,
                    c.epsilon, c.softargmax_beta, c.cost_threshold)
            if cuda:
                return stereo_pipeline_cuda(*args, *c.pipeline_tile())
            return stereo_pipeline_reference(*args)

    def trainable_disparity_maps(self, camera: torch.Tensor,
                                 projector: torch.Tensor) -> PipelineMaps:
        """Differentiable batched ``[B, H, W]`` pair to disparity maps.

        Banded and camera-only, the ``cuda`` backend runs the trainable
        fused pipeline (K3w forward at ``pipeline_blocks``' tile, K4
        backward at ``trainable_bwd_block_rows``'): the cost-volume
        cotangent never exists in device memory.  Where the saved volume
        would take more than :func:`keeps_volume` allows of the card's
        memory, it runs without it: K3m writes only the maps and K5
        recomputes each cost plane from the images, so no volume exists in
        either direction; that call is the span
        ``custereo.model.volume_free`` and adds 1 to
        ``COUNTS["train.volume_free"]``.  The values are the same either
        way.  The ``torch`` backend runs the plain twin.  Gradients flow
        through ``soft_disparity`` and ``confidence``.  The fused
        pipeline's VJP is banded and camera-only, so ``grad_projector`` and
        all-pairs take the volume path and :meth:`disparity` on either
        backend (where the JAX package's Pallas backend raises for
        all-pairs)."""
        c = self.config
        if c.grad_projector or c.num_disparities is None:
            return self._volume_maps(camera, projector)
        args = (camera, projector, c.num_disparities, c.kernel_size,
                c.epsilon, c.softargmax_beta, c.cost_threshold)
        if self._backend(camera) != "cuda":
            return stereo_pipeline_trainable_reference(*args)
        tile_rows, planes = c.pipeline_tile()
        kw = dict(tile_rows=tile_rows, planes=planes,
                  bwd_tile_rows=c.bwd_tile_rows())
        if camera.ndim != 3 or keeps_volume(
                *camera.shape, c.num_disparities,
                card_memory(camera.device.index or 0)):
            return stereo_pipeline_trainable(*args, **kw)
        with span("custereo.model.volume_free"):
            maps = stereo_pipeline_trainable(*args, save_volume=False, **kw)
        COUNTS["train.volume_free"] += 1
        return maps

    def disparity_maps_lr(self, camera: torch.Tensor,
                          projector: torch.Tensor,
                          tolerance: float = 1.0) -> PipelineMaps:
        """Disparity maps with the left-right consistency check.

        Runs :meth:`disparity_maps` in both directions (on the ``cuda``
        backend two K3 launches: the pair, then the horizontally flipped
        pair, whose left match is the right match; its soft disparity is
        flipped back) and zeroes the pixels whose two estimates disagree by
        more than ``tolerance`` px (``ops.consistency.lr_consistency_mask``).
        All-pairs checks shifts up to W - 1; it takes the volume path on
        ``torch`` and raises on ``cuda``, as :meth:`disparity_maps` does."""
        left = self.disparity_maps(camera, projector)
        right_f = self.disparity_maps(*matched_pair_right(camera, projector))
        d_right = flip_back(right_f.soft_disparity)
        nd = self.config.num_disparities
        if nd is None:
            nd = camera.shape[-1] - 1
        lr = lr_consistency_mask(left.soft_disparity, d_right, nd, tolerance)
        return PipelineMaps(disparity=left.disparity * lr,
                            soft_disparity=left.soft_disparity * lr,
                            mask=left.mask * lr, confidence=left.confidence)

    # -- mesh-sharded ---------------------------------------------------------
    def sharded_cost_volume(self, camera, projector, mesh):
        """Cost volume sharded over a ``(data, space)`` mesh
        (:func:`..parallel.sharded.sharded_cost_volume`): a ``DTensor``."""
        return sharded_cost_volume(camera, projector, self.config, mesh)

    def sharded_apply(self, camera, projector, mesh) -> StereoOutput:
        """Full pipeline with the volume sharded over ``mesh``.

        The disparity head is elementwise over the sharded axes (its
        reductions run along the unsharded disparity axis), so each rank
        runs it on its own block with no collective; every output is a
        ``DTensor`` with the images' placements.
        """
        cv = self.sharded_cost_volume(camera, projector, mesh)
        d = sharded_disparity(cv, self.config)
        return StereoOutput(cost_volume=cv, disparity=d.disparity,
                            soft_disparity=d.soft_disparity, mask=d.mask,
                            confidence=d.confidence)


def entry(device: Optional[torch.device] = None):
    """Forward step of the flagship matcher with its example inputs: the
    counterpart of ``__graft_entry__.entry`` (k = 15, D = 64, inputs
    ``[1, 96, 160]`` drawn from ``np.random.default_rng(0)``).

    Returns ``(forward, (camera, projector))`` with the inputs on
    ``device`` (the CUDA card unless the caller names another; without a
    card and without ``device="cpu"`` it raises ``RuntimeError``);
    ``forward`` returns the soft disparity.
    """
    device = entry_device(device)
    model = StereoMatcher(StereoConfig(kernel_size=15, num_disparities=64))

    def forward(camera, projector):
        return model(camera, projector).soft_disparity

    rng = np.random.default_rng(0)
    camera = torch.from_numpy(rng.random((1, 96, 160), dtype=np.float32))
    projector = torch.from_numpy(rng.random((1, 96, 160), dtype=np.float32))
    return forward, (camera.to(device), projector.to(device))
