"""Wrappers of kernels K11p, K11w and K11c: the pyramid matcher's glue on
the card, one launch a stage.

The kernels are ``csrc/pyramid_glue.cu``.  They replace no TPU kernel:
the JAX package leaves the glue to XLA.  Bytes bound them: each stage
reads its inputs once and writes its outputs once, where the plain glue
(``models/pyramid.py``: ``_avg_pool``, ``_shift_and_warp``, ``_compose``)
makes about 35 passes a call.  ``PyramidStereoMatcher`` calls these on
the ``cuda`` backend and its plain glue on ``torch``; each function here
takes CUDA float32 tensors and raises ``ValueError`` for anything else.
K11w and K11c give the plain glue's values bit for bit; K11p differs from
``_avg_pool`` by the order of each block's sum.
"""

from __future__ import annotations

from typing import Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps


def _check(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA float32 ``[..., H, W]`` one of
    the first's shape."""
    shape = tensors[0].shape
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{what}: expected CUDA float32 tensors, got "
                             f"{t.dtype} on {t.device}")
        if t.ndim < 2 or t.shape != shape:
            raise ValueError(f"{what}: expected [..., H, W] tensors of one "
                             f"shape, got {tuple(t.shape)} and "
                             f"{tuple(shape)}")


def _frames(t: torch.Tensor) -> int:
    H, W = t.shape[-2:]
    return t.numel() // (H * W) if H * W else 0


def pool_pair(camera: torch.Tensor, projector: torch.Tensor, f: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11p: both ``[..., H, W]`` images f x f mean-pooled, edge-padded to
    a multiple of f (``_avg_pool``'s function), in one launch."""
    _check("K11p", camera, projector)
    if f < 1:
        raise ValueError(f"K11p: the factor must be >= 1, got {f}")
    camera, projector = camera.contiguous(), projector.contiguous()
    H, W = camera.shape[-2:]
    lead = camera.shape[:-2]
    cam_out, proj_out = camera.new_empty(
        (2,) + lead + (-(-H // f), -(-W // f))).unbind(0)
    frames = _frames(camera)
    if frames:
        with torch.cuda.device(camera.device):
            _build.launch("K11p", "custereo_pyramid_pool", ptr(camera),
                          ptr(projector), ptr(cam_out), ptr(proj_out),
                          frames, H, W, f, stream_of(camera.device),
                          what="K11p pyramid pool launch")
    return cam_out, proj_out


def shift_and_warp(projector: torch.Tensor, coarse_soft: torch.Tensor,
                   f: int, r: int, D: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11w: ``(shift, warped projector)``, each ``[..., H, W]``, from the
    ``[..., h, w]`` coarse soft map (h f >= H, w f >= W): ``shift =
    clamp(round(coarse[y // f, x // f] f) - r, -r, D)`` and
    ``projector[..., y, x - shift]``, 0 where the column is out of view
    (``_shift_and_warp``'s function), in one launch."""
    _check("K11w", projector)
    _check("K11w", coarse_soft)
    H, W = projector.shape[-2:]
    h, w = coarse_soft.shape[-2:]
    if coarse_soft.shape[:-2] != projector.shape[:-2] or h * f < H \
            or w * f < W or f < 1 or r < 0:
        raise ValueError(f"K11w: a coarse map {tuple(coarse_soft.shape)} "
                         f"does not cover a frame {tuple(projector.shape)} "
                         f"at f = {f} (r = {r})")
    projector, coarse_soft = projector.contiguous(), coarse_soft.contiguous()
    shift, proj_w = projector.new_empty((2,) + projector.shape).unbind(0)
    frames = _frames(projector)
    if frames:
        with torch.cuda.device(projector.device):
            _build.launch("K11w", "custereo_pyramid_warp", ptr(projector),
                          ptr(coarse_soft), ptr(shift), ptr(proj_w), frames,
                          H, W, h, w, f, r, D, stream_of(projector.device),
                          what="K11w pyramid warp launch")
    return shift, proj_w


def compose(fine: PipelineMaps, shift: torch.Tensor, r: int
            ) -> PipelineMaps:
    """K11c: the fine level's maps over the band ``[0, 2r]`` to total
    disparities (``_compose``'s function), in one launch; the confidence
    passes through."""
    _check("K11c", fine.disparity, fine.soft_disparity, fine.mask, shift)
    hard, soft, mask, shift = (t.contiguous() for t in (
        fine.disparity, fine.soft_disparity, fine.mask, shift))
    H, W = shift.shape[-2:]
    out = shift.new_empty((3,) + shift.shape).unbind(0)
    frames = _frames(shift)
    if frames:
        with torch.cuda.device(shift.device):
            _build.launch("K11c", "custereo_pyramid_compose", ptr(hard),
                          ptr(soft), ptr(mask), ptr(shift),
                          *(ptr(t) for t in out), frames, H, W, r,
                          stream_of(shift.device),
                          what="K11c pyramid compose launch")
    return PipelineMaps(*out, confidence=fine.confidence)
