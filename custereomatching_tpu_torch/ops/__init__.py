"""Compute ops of the port: the banded ZNCC cost volume (plain PyTorch and
kernel K1), the fused pipeline (plain and kernel K3) and the disparity
head."""

from __future__ import annotations

from typing import Optional

import torch

from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import cost_volume_banded_cuda
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    disparity_to_depth,
    extract_disparity,
    soft_argmax,
)
from custereomatching_tpu_torch.ops.zncc import (
    ALLPAIRS_TODO,
    EPSILON,
    box2d,
    check_pair,
    stereo_matching_torch,
)


class _CudaStereoMatching(torch.autograd.Function):
    """K1 as an autograd node.  Inference only in this slice: the camera
    VJP kernel comes with the training slice, and a plain recompute is
    not silently differentiated in its place."""

    @staticmethod
    def forward(ctx, camera, projector, num_disparities, kernel_size,
                epsilon):
        return cost_volume_banded_cuda(camera, projector, num_disparities,
                                       kernel_size, epsilon)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "camera VJP kernel (K2) is ported with the training slice")


def stereo_matching(camera: torch.Tensor, projector: torch.Tensor,
                    num_disparities: Optional[int],
                    kernel_size: int = 15,
                    epsilon: float = EPSILON) -> torch.Tensor:
    """Banded ZNCC cost volume: ``[H, W]`` or ``[B, H, W]`` pairs to
    ``[..., H, W, D+1]`` volumes, band d matching projector column w - d.

    A CPU tensor takes the plain op (differentiable in the camera through
    autograd); a CUDA tensor launches K1, whose backward is not ported yet
    and raises.  ``num_disparities=None`` (all-pairs) raises
    ``NotImplementedError``.
    """
    if camera.device.type == "cpu":
        return stereo_matching_torch(camera, projector, num_disparities,
                                     kernel_size, epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"unsupported device {camera.device}")
    check_pair(camera, projector, kernel_size)
    if num_disparities is None:
        raise NotImplementedError(ALLPAIRS_TODO)
    single = camera.ndim == 2
    if single:
        camera, projector = camera[None], projector[None]
    cost = _CudaStereoMatching.apply(camera, projector, num_disparities,
                                     kernel_size, epsilon)
    return cost[0] if single else cost


__all__ = [
    "DisparityResult",
    "EPSILON",
    "PipelineMaps",
    "box2d",
    "cost_volume_banded_cuda",
    "disparity_to_depth",
    "extract_disparity",
    "soft_argmax",
    "stereo_matching",
    "stereo_matching_torch",
    "stereo_pipeline_cuda",
    "stereo_pipeline_reference",
]
