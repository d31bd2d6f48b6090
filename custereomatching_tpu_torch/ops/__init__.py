"""Compute ops of the port: the ZNCC cost volumes and their VJPs (plain
PyTorch and kernels K1, K2, K6, K7, K8, K8b), in the parity and the
plane-major layout, the layout conversions (K9a, K9b), the fused pipeline
(plain and kernel K3), its trainable forms (kernels K3w and K4, K3m and
K5), the disparity heads, the left-right consistency check, the golden oracle
(``golden``, a direct patch sum) and, where a kernel's blocks do not fit,
the large-k route (``cuda_large_k``)."""

from __future__ import annotations

from typing import Optional

import torch

from custereomatching_tpu_torch.ops import golden
from custereomatching_tpu_torch.ops.consistency import lr_consistency_mask
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    CudaAllPairsMatching,
    camera_grad_allpairs_cuda,
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    camera_grad_banded_cuda,
    camera_grad_banded_parity_cuda,
    cost_volume_banded_cuda,
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    disparity_to_depth,
    extract_disparity,
    extract_disparity_hdw,
    soft_argmax,
)
from custereomatching_tpu_torch.ops.layout import (
    parity_to_plane_major,
    plane_major_to_parity,
)
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    box2d,
    camera_grad_allpairs,
    camera_grad_banded,
    check_pair,
    forward_allpairs,
    projector_grad_banded,
    stereo_matching_torch,
    stereo_matching_with_proj_grad,
)


class _CudaStereoMatching(torch.autograd.Function):
    """K1 as an autograd node whose backward is K2 and, with
    ``grad_projector``, K7: the counterpart of ``_pallas_stereo`` and
    ``_pallas_stereo_both`` (and, under :func:`stereo_matching_hdw`'s
    ``movedim``, of ``_pallas_stereo_hdw`` and ``_pallas_stereo_hdw_both``).
    The residuals are the images and the plane-major volume K1 wrote.  Each
    backward kernel launches only when its input needs a gradient; without
    ``grad_projector`` the projector gets none (``None``)."""

    @staticmethod
    def forward(ctx, camera, projector, num_disparities, kernel_size,
                epsilon, grad_projector):
        cost = cost_volume_banded_cuda(camera, projector, num_disparities,
                                       kernel_size, epsilon)
        # cost is a [B, H, W, D+1] view of the plane-major volume.
        ctx.save_for_backward(camera, projector, cost)
        ctx.args = (num_disparities, kernel_size, epsilon)
        ctx.grad_projector = grad_projector
        return cost

    @staticmethod
    def backward(ctx, grad):
        camera, projector, cost = ctx.saved_tensors
        want_cam = ctx.needs_input_grad[0]
        want_proj = ctx.grad_projector and ctx.needs_input_grad[1]
        cam_grad = proj_grad = None
        if not (want_cam or want_proj):
            return None, None, None, None, None, None
        # The cotangent in the kernels' plane-major layout: one volume copy
        # for a parity cotangent (the transpose the JAX op pays at
        # pallas_zncc.py:527-529), none for the permuted view of a
        # plane-major one that stereo_matching_hdw's backward hands over.
        g = grad.permute(0, 3, 1, 2).contiguous()
        vol = cost.permute(0, 3, 1, 2)
        if want_cam:
            cam_grad = camera_grad_banded_cuda(camera, projector, vol, g,
                                               *ctx.args)
        if want_proj:
            proj_grad = projector_grad_banded_cuda(camera, projector, vol, g,
                                                   *ctx.args)
        return cam_grad, proj_grad, None, None, None, None


def stereo_matching(camera: torch.Tensor, projector: torch.Tensor,
                    num_disparities: Optional[int],
                    kernel_size: int = 15,
                    epsilon: float = EPSILON,
                    grad_projector: bool = False,
                    precision: str = "highest") -> torch.Tensor:
    """ZNCC cost volume: ``[H, W]`` or ``[B, H, W]`` pairs to banded
    ``[..., H, W, D+1]`` volumes (band d matching projector column w - d),
    or with ``num_disparities=None`` to all-pairs ``[..., H, W, W]``
    volumes (the last axis the absolute projector column).

    A CPU tensor takes the plain op.  On a CUDA tensor the banded volume
    launches K1, its camera gradient K2 and, with ``grad_projector``, its
    projector gradient K7; the all-pairs volume launches K8, and its
    camera gradient K8b (the JAX package leaves that VJP to XLA).
    All-pairs with ``grad_projector`` is autograd of the plain moments
    form on any device, as in the JAX package.  Without
    ``grad_projector`` the projector gets no gradient.  ``precision`` is
    the JAX op's knob; every kernel here sums in exact fp32 for both
    values.
    """
    if camera.device.type == "cpu":
        if grad_projector:
            return stereo_matching_with_proj_grad(
                camera, projector, num_disparities, kernel_size, epsilon)
        return stereo_matching_torch(camera, projector, num_disparities,
                                     kernel_size, epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"unsupported device {camera.device}")
    check_pair(camera, projector, kernel_size)
    if num_disparities is None and grad_projector:
        return stereo_matching_with_proj_grad(camera, projector, None,
                                              kernel_size, epsilon)
    single = camera.ndim == 2
    if single:
        camera, projector = camera[None], projector[None]
    if num_disparities is None:
        cost = CudaAllPairsMatching.apply(camera, projector, kernel_size,
                                          epsilon, precision)
    else:
        cost = _CudaStereoMatching.apply(camera, projector, num_disparities,
                                         kernel_size, epsilon,
                                         grad_projector)
    return cost[0] if single else cost


def cost_volume(camera: torch.Tensor, projector: torch.Tensor,
                config) -> torch.Tensor:
    """ZNCC cost volume ``[B, H, W, L]`` of a ``[B, H, W]`` batch as a
    :class:`~custereomatching_tpu_torch.config.StereoConfig` routes it:
    L is D+1 (banded) or W (all-pairs, ``num_disparities=None``).

    Routed as the JAX ``cost_volume_single``: with ``grad_projector``
    the volume is differentiable in both images (``cuda``, banded: K1
    with K2 and K7 backward; otherwise autograd of the plain moments
    form); without it, in the camera only (K1 + K2, K8 + K8b, or the
    plain ops)."""
    c = config
    if c.resolved_backend(camera.device) == "cuda":
        return stereo_matching(camera, projector, c.num_disparities,
                               c.kernel_size, c.epsilon, c.grad_projector,
                               c.precision)
    if c.grad_projector:
        return stereo_matching_with_proj_grad(
            camera, projector, c.num_disparities, c.kernel_size, c.epsilon)
    return stereo_matching_torch(camera, projector, c.num_disparities,
                                 c.kernel_size, c.epsilon)


def stereo_matching_hdw(camera: torch.Tensor, projector: torch.Tensor,
                        num_disparities: int, kernel_size: int = 15,
                        epsilon: float = EPSILON,
                        grad_projector: bool = False) -> torch.Tensor:
    """Differentiable banded ZNCC volume in the plane-major layout:
    ``[H, W]`` or ``[B, H, W]`` pairs to the exact ``[D+1, H, W]`` or
    ``[B, D+1, H, W]`` volume (the counterpart of
    ``stereo_matching_pallas_hdw``, whose padded extents are TPU geometry).
    It pairs with :func:`extract_disparity_hdw`, so a training loss needs
    no permute.

    It is :func:`stereo_matching`'s banded volume with the plane axis moved
    to the front.  On a CUDA tensor that volume is a permuted view of the
    plane-major buffer K1 writes, so the result is that buffer as it is;
    the backward is K2 and, with ``grad_projector``, K7, and the permute
    of the cotangent it hands them is a view, so no volume is copied.  A
    CPU tensor takes the plain op.  Without ``grad_projector`` the
    projector gets no gradient.
    """
    if num_disparities is None:
        raise ValueError("the plane-major op is banded: num_disparities "
                         "must be an int")
    return stereo_matching(camera, projector, num_disparities, kernel_size,
                           epsilon, grad_projector).movedim(-1, -3)


__all__ = [
    "golden",
    "DisparityResult",
    "EPSILON",
    "PipelineMaps",
    "box2d",
    "camera_grad_allpairs",
    "camera_grad_allpairs_cuda",
    "camera_grad_banded",
    "camera_grad_banded_cuda",
    "camera_grad_banded_parity_cuda",
    "cost_volume",
    "cost_volume_allpairs_cuda",
    "cost_volume_banded_cuda",
    "disparity_to_depth",
    "extract_disparity",
    "extract_disparity_hdw",
    "forward_allpairs",
    "lr_consistency_mask",
    "parity_to_plane_major",
    "plane_major_to_parity",
    "projector_grad_banded",
    "projector_grad_banded_cuda",
    "soft_argmax",
    "stereo_matching",
    "stereo_matching_hdw",
    "stereo_matching_torch",
    "stereo_matching_with_proj_grad",
    "stereo_pipeline_cuda",
    "stereo_pipeline_reference",
    "stereo_pipeline_trainable",
    "stereo_pipeline_trainable_reference",
]
