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

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.ops import stereo_matching
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
from custereomatching_tpu_torch.ops.zncc import (
    stereo_matching_torch,
    stereo_matching_with_proj_grad,
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

    The ``cuda`` backend runs the kernels on CUDA tensors: K1 for a banded
    :meth:`cost_volume`, K2 for its camera gradient and, with
    ``grad_projector``, K7 for its projector gradient; K8 for an all-pairs
    :meth:`cost_volume`; K3 for :meth:`disparity_maps`, K3w and K4 for
    :meth:`trainable_disparity_maps`.  The ``torch`` backend runs their
    plain versions.  The model has no parameters: its state is the config.
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
        D+1 (banded) or W (all-pairs, ``num_disparities=None``).

        Routed as the JAX ``cost_volume_single``: with ``grad_projector``
        the volume is differentiable in both images (``cuda``, banded: K1
        with K2 and K7 backward; otherwise autograd of the plain moments
        form); without it, in the camera only (K1 + K2, K8 + the plain
        all-pairs VJP, or the plain ops)."""
        c = self.config
        if self._backend(camera) == "cuda":
            return stereo_matching(camera, projector, c.num_disparities,
                                   c.kernel_size, c.epsilon,
                                   c.grad_projector, c.precision)
        if c.grad_projector:
            return stereo_matching_with_proj_grad(
                camera, projector, c.num_disparities, c.kernel_size,
                c.epsilon)
        return stereo_matching_torch(camera, projector, c.num_disparities,
                                     c.kernel_size, c.epsilon)

    def disparity(self, cost_volume: torch.Tensor) -> DisparityResult:
        """Batched disparity head over a ``[B, H, W, L]`` volume."""
        c = self.config
        return extract_disparity(cost_volume, c.num_disparities,
                                 c.cost_threshold, c.softargmax_beta)

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
        volume path on ``torch``, as in the JAX package."""
        c = self.config
        cuda = self._backend(camera) == "cuda"
        if c.num_disparities is None:
            if cuda:
                raise ValueError("fused pipeline requires banded mode")
            return self._volume_maps(camera, projector)
        run = stereo_pipeline_cuda if cuda else stereo_pipeline_reference
        return run(camera, projector, c.num_disparities, c.kernel_size,
                   c.epsilon, c.softargmax_beta, c.cost_threshold)

    def trainable_disparity_maps(self, camera: torch.Tensor,
                                 projector: torch.Tensor) -> PipelineMaps:
        """Differentiable batched ``[B, H, W]`` pair to disparity maps.

        Banded and camera-only, the ``cuda`` backend runs the trainable
        fused pipeline (K3w forward, K4 backward): the cost-volume
        cotangent never exists in device memory; the ``torch`` backend runs
        its plain twin.  Gradients flow through ``soft_disparity`` and
        ``confidence``.  The fused pipeline's VJP is banded and
        camera-only, so ``grad_projector`` and all-pairs take the volume
        path and the plain head on either backend (where the JAX package's
        Pallas backend raises for all-pairs)."""
        c = self.config
        if c.grad_projector or c.num_disparities is None:
            return self._volume_maps(camera, projector)
        run = (stereo_pipeline_trainable if self._backend(camera) == "cuda"
               else stereo_pipeline_trainable_reference)
        return run(camera, projector, c.num_disparities, c.kernel_size,
                   c.epsilon, c.softargmax_beta, c.cost_threshold)

    # -- not ported yet -------------------------------------------------------
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
