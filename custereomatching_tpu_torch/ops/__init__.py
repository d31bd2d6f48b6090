"""Compute ops of the port: the banded ZNCC cost volume and its camera VJP
(plain PyTorch and kernels K1, K2), the fused pipeline (plain and kernel
K3), its trainable form (kernels K3w, K4) and the disparity heads."""

from __future__ import annotations

from typing import Optional

import torch

from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    camera_grad_banded_cuda,
    cost_volume_banded_cuda,
)
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    disparity_to_depth,
    extract_disparity,
    extract_disparity_hdw,
    soft_argmax,
)
from custereomatching_tpu_torch.ops.zncc import (
    ALLPAIRS_TODO,
    EPSILON,
    box2d,
    camera_grad_banded,
    check_pair,
    stereo_matching_torch,
)


class _CudaStereoMatching(torch.autograd.Function):
    """K1 as an autograd node whose backward is K2, the counterpart of
    ``_pallas_stereo_fwd``/``_pallas_stereo_bwd``: the residuals are the
    images and the plane-major volume K1 wrote, and the projector gets no
    gradient (``None``)."""

    @staticmethod
    def forward(ctx, camera, projector, num_disparities, kernel_size,
                epsilon):
        cost = cost_volume_banded_cuda(camera, projector, num_disparities,
                                       kernel_size, epsilon)
        # cost is a [B, H, W, D+1] view of the plane-major volume.
        ctx.save_for_backward(camera, projector, cost)
        ctx.args = (num_disparities, kernel_size, epsilon)
        return cost

    @staticmethod
    def backward(ctx, grad):
        camera, projector, cost = ctx.saved_tensors
        # One volume copy: the cotangent into K2's plane-major layout (the
        # transpose the JAX op pays at pallas_zncc.py:527-529).
        g = grad.permute(0, 3, 1, 2).contiguous()
        cam_grad = camera_grad_banded_cuda(camera, projector,
                                           cost.permute(0, 3, 1, 2), g,
                                           *ctx.args)
        return cam_grad, None, None, None, None


def stereo_matching(camera: torch.Tensor, projector: torch.Tensor,
                    num_disparities: Optional[int],
                    kernel_size: int = 15,
                    epsilon: float = EPSILON) -> torch.Tensor:
    """Banded ZNCC cost volume: ``[H, W]`` or ``[B, H, W]`` pairs to
    ``[..., H, W, D+1]`` volumes, band d matching projector column w - d.

    A CPU tensor takes the plain op; a CUDA tensor launches K1, and its
    camera gradient launches K2.  Both backwards are the closed form, and
    the projector gets no gradient.  ``num_disparities=None`` (all-pairs)
    raises ``NotImplementedError``.
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
    "camera_grad_banded",
    "camera_grad_banded_cuda",
    "cost_volume_banded_cuda",
    "disparity_to_depth",
    "extract_disparity",
    "extract_disparity_hdw",
    "soft_argmax",
    "stereo_matching",
    "stereo_matching_torch",
    "stereo_pipeline_cuda",
    "stereo_pipeline_reference",
    "stereo_pipeline_trainable",
    "stereo_pipeline_trainable_reference",
]
