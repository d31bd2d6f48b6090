"""Wrapper of kernel K3, the fused volume-free stereo pipeline on the card.

The counterpart of ``custereomatching_tpu/ops/pallas_pipeline.py``
(``PipelineMaps``, ``_unnormalized_head`` and ``pallas_stereo_pipeline``,
i.e. ``_fused_kernel`` with ``write_volume=False``).  The kernel is
``csrc/fused_pipeline.cu``; its plain version is
:func:`stereo_pipeline_reference`, the plain volume followed by the plain
head, which is what the JAX ``xla`` backend computes for
``StereoMatcher.disparity_maps``.  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or the call raises.  Inference only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.cuda_zncc import (
    prepare,
    ptr,
    stats_scratch,
    stream_of,
)
from custereomatching_tpu_torch.ops.disparity import extract_disparity
from custereomatching_tpu_torch.ops.zncc import EPSILON, forward_banded


class PipelineMaps(NamedTuple):
    """Outputs of the fused pipeline (each ``[B, H, W]``)."""

    disparity: torch.Tensor       # hard argmax disparity, masked
    soft_disparity: torch.Tensor  # sub-pixel soft-argmax disparity, masked
    mask: torch.Tensor            # confidence mask (max cost > threshold)
    confidence: torch.Tensor      # per-pixel max correlation


def unnormalized_head(beta: float, num_disparities: int) -> bool:
    """Whether (beta, D) permit the unnormalized softmax head.

    With ``|c| <= 1 + eps`` the largest accumulator is
    ``t = sum d e^{beta c} <= D (D+1) e^{beta (1+eps)}``; requiring
    ``beta + ln(D (D+1)) <= 85`` keeps it far inside fp32 range.
    """
    d = int(num_disparities)
    return float(beta) + math.log((d + 1) * max(d, 1)) <= 85.0


def stereo_pipeline_reference(camera: torch.Tensor, projector: torch.Tensor,
                              num_disparities: int, kernel_size: int = 15,
                              epsilon: float = EPSILON, beta: float = 50.0,
                              threshold: float = 0.6) -> PipelineMaps:
    """Plain version of K3: the banded volume, then the disparity head.
    ``.calls`` counts its uses."""
    stereo_pipeline_reference.calls += 1
    cost = forward_banded(camera, projector, num_disparities, kernel_size,
                          epsilon)
    d = extract_disparity(cost, num_disparities, threshold, beta)
    return PipelineMaps(disparity=d.disparity,
                        soft_disparity=d.soft_disparity, mask=d.mask,
                        confidence=d.confidence)


stereo_pipeline_reference.calls = 0


def stereo_pipeline_cuda(camera: torch.Tensor, projector: torch.Tensor,
                         num_disparities: int, kernel_size: int = 15,
                         epsilon: float = EPSILON, beta: float = 50.0,
                         threshold: float = 0.6) -> PipelineMaps:
    """``[B, H, W]`` pairs to four ``[B, H, W]`` disparity maps, with no
    cost volume in device memory.  ``.launches`` counts K3's launches."""
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    if camera.device.type == "cpu":
        return stereo_pipeline_reference(camera, projector, D, k, epsilon,
                                         beta, threshold)
    if camera.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    lib = _build.kernels()
    B, H, W = camera.shape
    maps = camera.new_empty((4, B, H, W))
    scratch = stats_scratch(camera, D)
    with torch.cuda.device(camera.device):
        code = lib.custereo_fused_pipeline(
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch),
            *(ptr(m) for m in maps), B, H, W, D, k, float(epsilon),
            float(beta), float(threshold), int(unnormalized_head(beta, D)),
            stream_of(camera.device))
    _build.check(code, "K3 fused pipeline launch")
    stereo_pipeline_cuda.launches += 1
    return PipelineMaps(*maps.unbind(0))


stereo_pipeline_cuda.launches = 0
