"""Flagship model: the end-to-end structured-light stereo matcher (PyTorch).

The counterpart of ``custereomatching_tpu/models/stereo.py``: image pair,
ZNCC cost volume, confidence mask, hard and soft disparity.  A batch runs
as the kernels' grid batch dimension (one launch for all frames), so the
JAX package's frame stacking along H (``_stack_gap``/``_run_stacked``,
which encode the TPU window-sum read reach) has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.ops import stereo_matching
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
)
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    extract_disparity,
)
from custereomatching_tpu_torch.ops.zncc import (
    ALLPAIRS_TODO,
    stereo_matching_torch,
)


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

    The ``cuda`` backend runs K1 (:meth:`cost_volume`) and K3
    (:meth:`disparity_maps`) on CUDA tensors; the ``torch`` backend runs
    their plain versions.  The model has no parameters: its state is
    the config.
    """

    def __init__(self, config: StereoConfig = StereoConfig()):
        super().__init__()
        self.config = config

    def _backend(self, camera: torch.Tensor) -> str:
        c = self.config
        if c.grad_projector:
            raise NotImplementedError(
                "grad_projector=True: the projector gradient is not ported "
                "yet (ROADMAP item 10)")
        if c.num_disparities is None:
            raise NotImplementedError(ALLPAIRS_TODO)
        return c.resolved_backend(camera.device)

    # -- volume path --------------------------------------------------------
    def cost_volume_single(self, camera: torch.Tensor,
                           projector: torch.Tensor) -> torch.Tensor:
        """ZNCC cost volume ``[H, W, D+1]`` of one ``[H, W]`` pair."""
        return self.cost_volume(camera[None], projector[None])[0]

    def cost_volume(self, camera: torch.Tensor,
                    projector: torch.Tensor) -> torch.Tensor:
        """ZNCC cost volume ``[B, H, W, D+1]`` of a ``[B, H, W]`` batch."""
        c = self.config
        if self._backend(camera) == "cuda":
            return stereo_matching(camera, projector, c.num_disparities,
                                   c.kernel_size, c.epsilon)
        return stereo_matching_torch(camera, projector, c.num_disparities,
                                     c.kernel_size, c.epsilon)

    def disparity(self, cost_volume: torch.Tensor) -> DisparityResult:
        """Batched disparity head over a ``[B, H, W, L]`` volume."""
        c = self.config
        return extract_disparity(cost_volume, c.num_disparities,
                                 c.cost_threshold, c.softargmax_beta)

    def forward(self, camera: torch.Tensor,
                projector: torch.Tensor) -> StereoOutput:
        """Full pipeline on a ``[B, H, W]`` batch."""
        cv = self.cost_volume(camera, projector)
        d = self.disparity(cv)
        return StereoOutput(cost_volume=cv, disparity=d.disparity,
                            soft_disparity=d.soft_disparity, mask=d.mask,
                            confidence=d.confidence)

    # -- fused inference path -----------------------------------------------
    def disparity_maps(self, camera: torch.Tensor,
                       projector: torch.Tensor) -> PipelineMaps:
        """Batched ``[B, H, W]`` pair to disparity maps, volume-free on the
        ``cuda`` backend (K3).  Inference only."""
        c = self.config
        run = (stereo_pipeline_cuda if self._backend(camera) == "cuda"
               else stereo_pipeline_reference)
        return run(camera, projector, c.num_disparities, c.kernel_size,
                   c.epsilon, c.softargmax_beta, c.cost_threshold)

    # -- not ported yet -------------------------------------------------------
    def trainable_disparity_maps(self, camera, projector):
        raise NotImplementedError(
            "trainable_disparity_maps: the fused trainable pipeline is the "
            "training slice (ROADMAP item 7)")

    def disparity_maps_lr(self, camera, projector, tolerance: float = 1.0):
        raise NotImplementedError(
            "disparity_maps_lr: the left-right check is ROADMAP item 11")

    def sharded_cost_volume(self, camera, projector, mesh=None):
        raise NotImplementedError(
            "sharded_cost_volume: the parallel layer is ROADMAP item 13")

    def sharded_apply(self, camera, projector, mesh=None):
        raise NotImplementedError(
            "sharded_apply: the parallel layer is ROADMAP item 13")


def entry(device: Optional[torch.device] = None):
    """Forward step of the flagship matcher with its example inputs: the
    counterpart of ``__graft_entry__.entry`` (k = 15, D = 64, inputs
    ``[1, 96, 160]`` drawn from ``np.random.default_rng(0)``).

    Returns ``(forward, (camera, projector))`` with the inputs on
    ``device`` (CUDA when available, else CPU); ``forward`` returns the
    soft disparity.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    model = StereoMatcher(StereoConfig(kernel_size=15, num_disparities=64))

    def forward(camera, projector):
        return model(camera, projector).soft_disparity

    rng = np.random.default_rng(0)
    camera = torch.from_numpy(rng.random((1, 96, 160), dtype=np.float32))
    projector = torch.from_numpy(rng.random((1, 96, 160), dtype=np.float32))
    return forward, (camera.to(device), projector.to(device))
