"""Wrappers of kernels K3, K3w, K3m, K4 and K5: the fused stereo pipeline
on the card, its training forwards and its backwards.

The counterpart of ``custereomatching_tpu/ops/pallas_pipeline.py``
(``PipelineMaps``, ``_unnormalized_head``, ``pallas_stereo_pipeline``,
i.e. ``_fused_kernel`` with ``write_volume=False``;
``stereo_pipeline_trainable(save_volume=True)``, i.e. ``_fused_kernel``
with ``write_volume=True`` plus ``_fused_bwd_c_kernel``; and
``stereo_pipeline_trainable(save_volume=False)``, i.e. ``_fused_kernel``
without the volume plus ``_fused_bwd_kernel``).  The kernels are
``csrc/fused_pipeline.cu`` (K3; K3w and K3m are its training variants,
with and without the volume) and ``csrc/fused_pipeline_bwd.cu`` (K4, and
K5, which recomputes the cost).  Each has a plain version here:

  * K3: :func:`stereo_pipeline_reference`, the plain volume followed by the
    plain head, which is what the JAX ``xla`` backend computes for
    ``StereoMatcher.disparity_maps``;
  * K3w and K3m: :func:`fused_pipeline_train_reference`, the plain volume
    and :func:`head_residuals`, the volume kept (K3w) or dropped (K3m);
  * K4 and K5: :func:`fused_pipeline_bwd_reference`,
    :func:`head_cotangent` on the residual volume (or, for K5, the plain
    volume recomputed) followed by the closed-form camera VJP.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.  :func:`fused_pipeline_train_cuda` launches K3w or, without
``save_volume``, K3m; :func:`fused_pipeline_bwd_cuda` launches K4 or, when
the residuals hold no volume, K5.  :func:`stereo_pipeline_trainable` is the
autograd node over K3w and K4 (``save_volume=True``) or K3m and K5
(``False``); :func:`stereo_pipeline_trainable_reference` is its plain twin,
the closed-form volume op followed by a head whose backward forms the head
cotangent explicitly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.cuda_large_k import (
    camera_grad_large,
    fused_pipeline_large,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    check_volume,
    cost_slab,
    grad_scratch,
    own_blocks,
    prepare,
    ptr_or_null,
    smem_floats,
    stats_scratch,
)
from custereomatching_tpu_torch.ops.disparity import extract_disparity
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    StereoMatchingFunction,
    camera_grad_banded,
    forward_banded,
)
from custereomatching_tpu_torch.utils.kernel_model import (
    K_TILE_H,
    large_k_route,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS


class PipelineMaps(NamedTuple):
    """Outputs of the fused pipeline (each ``[B, H, W]``).  In the
    trainable pipeline gradients flow through ``soft_disparity`` and
    ``confidence``; ``disparity`` and ``mask`` are piecewise constant and
    get none."""

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
    """Plain version of K3: the banded volume, then the disparity head."""
    COUNTS["plain.stereo_pipeline_reference"] += 1
    cost = forward_banded(camera, projector, num_disparities, kernel_size,
                          epsilon)
    d = extract_disparity(cost, num_disparities, threshold, beta)
    return PipelineMaps(disparity=d.disparity,
                        soft_disparity=d.soft_disparity, mask=d.mask,
                        confidence=d.confidence)


def stereo_pipeline_cuda(camera: torch.Tensor, projector: torch.Tensor,
                         num_disparities: int, kernel_size: int = 15,
                         epsilon: float = EPSILON, beta: float = 50.0,
                         threshold: float = 0.6, tile_rows: int = K_TILE_H,
                         planes: int = 0) -> PipelineMaps:
    """``[B, H, W]`` pairs to four ``[B, H, W]`` disparity maps, with no
    cost volume in device memory.  ``tile_rows`` (8, 16 or 32) and
    ``planes`` (a round, 0 for the kernel's own choice) set K3's tile, the
    counterpart of JAX's ``pipeline_blocks``; the maps are the same at
    every tile, and one that does not fit raises ``ValueError``
    (``cuda_zncc.own_blocks``).  Where K3's block does not fit at the
    default tile (k >= 129 on an H100) the large-k route runs it a slab of
    planes at a time (``cuda_large_k.fused_pipeline_large``)."""
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
    if not own_blocks("K3", camera, D, k, tile_rows, planes):
        maps, _ = fused_pipeline_large(camera, projector, D, k, epsilon, beta,
                                       threshold, unnormalized_head(beta, D))
        return PipelineMaps(*maps[:4].unbind(0))
    B, H, W = camera.shape
    maps = camera.new_empty((4, B, H, W))
    scratch = stats_scratch(camera, D)
    with torch.cuda.device(camera.device):
        _build.launch(
            "K3", "custereo_fused_pipeline",
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch),
            *(ptr(m) for m in maps), B, H, W, D, k, float(epsilon),
            float(beta), float(threshold), int(unnormalized_head(beta, D)),
            stream_of(camera.device), int(tile_rows), int(planes),
            what="K3 fused pipeline launch")
    return PipelineMaps(*maps.unbind(0))


# ---------------------------------------------------------------------------
# Trainable pipeline: K3w forward and K4 backward, or K3m and K5
# ---------------------------------------------------------------------------
#
# With soft = mask t/s and conf = m, the cotangent of cost plane d is
#     g_d = gs_hat mask beta w_d (d - t/s) + gc_hat 1[d = am]
#     w_d = e^{beta c_d} / s (unnormalized head), e^{beta (c_d - conf)} / s
# The confidence gradient goes to the first argmax only (1[d = am]); torch's
# amax backward would split it among tied maxima instead.


class HeadResiduals(NamedTuple):
    """What the trainable backward (K4 or K5) reads besides the images and
    the cotangents (each map ``[B, H, W]``)."""

    am: torch.Tensor          # raw first argmax (disparity = am * mask)
    mask: torch.Tensor        # the forward's confidence mask
    confidence: torch.Tensor  # max cost m
    s: torch.Tensor           # softmax sum: raw, or relative to e^{beta m}
    t: torch.Tensor           # first moment sum d e^{...}, as s
    # The cost volume, plane-major [B, D+1, H, W]; None after K3m (K5
    # recomputes it).
    volume: Optional[torch.Tensor] = None


def head_residuals(cost: torch.Tensor, num_disparities: int, beta: float
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain head over a ``[B, H, W, D+1]`` volume: ``(am, conf, s, t)`` in
    K3w's convention (s and t raw under the unnormalized gate, relative to
    ``e^{beta conf}`` otherwise)."""
    conf = torch.amax(cost, dim=-1)
    am = torch.argmax(cost, dim=-1).to(cost.dtype)
    bc = cost * beta
    if unnormalized_head(beta, num_disparities):
        u = torch.exp(bc)
    else:
        u = torch.exp(bc - torch.amax(bc, dim=-1, keepdim=True))
    d = torch.arange(cost.shape[-1], dtype=cost.dtype, device=cost.device)
    return am, conf, u.sum(dim=-1), (u * d).sum(dim=-1)


def _maps(am, conf, s, t, threshold: float) -> PipelineMaps:
    mask = (conf > threshold).to(conf.dtype)
    return PipelineMaps(disparity=am * mask, soft_disparity=(t / s) * mask,
                        mask=mask, confidence=conf)


def fused_pipeline_train_reference(camera: torch.Tensor,
                                   projector: torch.Tensor,
                                   num_disparities: int,
                                   kernel_size: int = 15,
                                   epsilon: float = EPSILON,
                                   beta: float = 50.0,
                                   threshold: float = 0.6,
                                   save_volume: bool = True
                                   ) -> Tuple[PipelineMaps, HeadResiduals]:
    """Plain version of K3w and (without ``save_volume``) K3m: the plain
    volume and :func:`head_residuals`, the volume kept or dropped."""
    COUNTS["plain.fused_pipeline_train_reference"] += 1
    cost = forward_banded(camera, projector, num_disparities, kernel_size,
                          epsilon)
    am, conf, s, t = head_residuals(cost, num_disparities, beta)
    maps = _maps(am, conf, s, t, threshold)
    return maps, HeadResiduals(
        am, maps.mask, conf, s, t,
        cost.permute(0, 3, 1, 2) if save_volume else None)


def fused_pipeline_train_cuda(camera: torch.Tensor, projector: torch.Tensor,
                              num_disparities: int, kernel_size: int = 15,
                              epsilon: float = EPSILON, beta: float = 50.0,
                              threshold: float = 0.6,
                              save_volume: bool = True,
                              tile_rows: int = K_TILE_H, planes: int = 0
                              ) -> Tuple[PipelineMaps, HeadResiduals]:
    """The training forward: the four maps of :func:`stereo_pipeline_cuda`
    plus the raw argmax, s and t, and with ``save_volume`` the cost volume
    ``[B, D+1, H, W]`` (K3w), else none (K3m: ``HeadResiduals.volume`` is
    None), at the tile ``(tile_rows, planes)`` of
    :func:`stereo_pipeline_cuda`."""
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    if camera.device.type == "cpu":
        return fused_pipeline_train_reference(camera, projector, D, k,
                                              epsilon, beta, threshold,
                                              save_volume)
    what = "K3w" if save_volume else "K3m"
    if camera.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    if not own_blocks(what, camera, D, k, tile_rows, planes):
        maps, vol = fused_pipeline_large(
            camera, projector, D, k, epsilon, beta, threshold,
            unnormalized_head(beta, D), residuals=True, volume=save_volume)
        disparity, soft, mask, conf, am, s, t = maps.unbind(0)
        return (PipelineMaps(disparity, soft, mask, conf),
                HeadResiduals(am, mask, conf, s, t, vol))
    entry = ("custereo_fused_pipeline_train" if save_volume
             else "custereo_fused_pipeline_train_maps")
    B, H, W = camera.shape
    maps = camera.new_empty((7, B, H, W))
    volume = (camera.new_empty((B, D + 1, H, W)),) if save_volume else ()
    scratch = stats_scratch(camera, D)
    with torch.cuda.device(camera.device):
        _build.launch(
            what, entry,
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch),
            *(ptr(m) for m in maps[:4]), *(ptr(v) for v in volume),
            *(ptr(m) for m in maps[4:]), B, H, W, D, k, float(epsilon),
            float(beta), float(threshold), int(unnormalized_head(beta, D)),
            stream_of(camera.device), int(tile_rows), int(planes),
            what=f"{what} fused pipeline (training) launch")
    disparity, soft, mask, conf, am, s, t = maps.unbind(0)
    return (PipelineMaps(disparity, soft, mask, conf),
            HeadResiduals(am, mask, conf, s, t, *volume))


def head_cotangent(cost: torch.Tensor, am: torch.Tensor, mask: torch.Tensor,
                   conf: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                   gsoft: torch.Tensor, gconf: torch.Tensor, beta: float,
                   unnormalized: bool) -> torch.Tensor:
    """The cost-volume cotangent ``[B, H, W, D+1]`` that the soft-disparity
    and confidence cotangents ``gsoft``, ``gconf`` induce, in K4's formula
    (the Pallas ``_fused_bwd_c_kernel``, pallas_pipeline.py:979-990) and its
    first-argmax convention."""
    inv_s = 1.0 / s
    tos = (t * inv_s)[..., None]
    gs = (gsoft * mask * beta)[..., None]
    arg = beta * cost if unnormalized else beta * (cost - conf[..., None])
    w = torch.exp(arg) * inv_s[..., None]
    d = torch.arange(cost.shape[-1], dtype=cost.dtype, device=cost.device)
    hit = (am[..., None] == d).to(cost.dtype)
    return gs * w * (d - tos) + gconf[..., None] * hit


def fused_pipeline_bwd_reference(camera: torch.Tensor,
                                 projector: torch.Tensor,
                                 residuals: HeadResiduals,
                                 gsoft: torch.Tensor, gconf: torch.Tensor,
                                 num_disparities: int, kernel_size: int = 15,
                                 epsilon: float = EPSILON,
                                 beta: float = 50.0) -> torch.Tensor:
    """Plain version of K4 and K5: :func:`head_cotangent` on the residual
    volume (K4) or, when ``residuals.volume`` is None, on the plain volume
    recomputed (K5); then the closed-form camera VJP."""
    COUNTS["plain.fused_pipeline_bwd_reference"] += 1
    D, k = int(num_disparities), int(kernel_size)
    r = residuals
    cost = (forward_banded(camera, projector, D, k, epsilon)
            if r.volume is None else r.volume.permute(0, 2, 3, 1))
    g = head_cotangent(cost, r.am, r.mask, r.confidence, r.s, r.t, gsoft,
                       gconf, beta, unnormalized_head(beta, D))
    return camera_grad_banded(camera, projector, g, D, k, epsilon)


def _check_maps(camera: torch.Tensor, what: str, **maps: torch.Tensor):
    out = []
    for name, m in maps.items():
        if (tuple(m.shape) != tuple(camera.shape) or m.dtype != camera.dtype
                or m.device != camera.device):
            raise ValueError(f"{what} {name}: expected "
                             f"{tuple(camera.shape)} {camera.dtype} on "
                             f"{camera.device}, got {tuple(m.shape)} "
                             f"{m.dtype} on {m.device}")
        out.append(m.contiguous())
    return out


def fused_pipeline_bwd_cuda(camera: torch.Tensor, projector: torch.Tensor,
                            residuals: HeadResiduals,
                            gsoft: torch.Tensor, gconf: torch.Tensor,
                            num_disparities: int, kernel_size: int = 15,
                            epsilon: float = EPSILON,
                            beta: float = 50.0,
                            tile_rows: int = K_TILE_H) -> torch.Tensor:
    """Camera gradient ``[B, H, W]`` of the trainable pipeline from the
    forward's residuals and the soft-disparity and confidence cotangents.

    On a CUDA tensor this launches K4, which reads ``residuals.volume``,
    its rounds kernel at a tile of ``tile_rows`` rows (8, 16 or 32: the
    counterpart of JAX's ``bwd_block_rows``; the gradient is the same at
    every tile, and one that does not fit raises ``ValueError``), or, when
    the volume is None (K3m's residuals), K5, which recomputes each cost
    plane from the images (past its block, a slab of
    ``kernel_model.COST_CHUNK`` planes at a time: never the whole volume)
    and has no tile to set (``tile_rows`` is not read).  Where neither
    kernel's blocks fit (K5 from k = 129, K4 from k = 187 on an H100) the
    large-k route runs (``cuda_large_k.camera_grad_large``).
    """
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    if camera.device.type == "cpu":
        return fused_pipeline_bwd_reference(camera, projector, residuals,
                                            gsoft, gconf, D, k, epsilon,
                                            beta)
    r = residuals
    free = r.volume is None
    what = "K5" if free else "K4"
    if camera.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    head = _check_maps(camera, what, am=r.am, mask=r.mask, conf=r.confidence,
                       s=r.s, t=r.t, gsoft=gsoft, gconf=gconf)
    volume = () if free else (check_volume(r.volume, camera, D, "K4 cost"),)
    if free:
        own = not large_k_route(what, k, D, smem_floats(camera.device))
    else:
        own = own_blocks(what, camera, D, k, tile_rows)
    if not own:
        return camera_grad_large(
            camera, projector, volume[0] if volume else None, None, D, k,
            epsilon, head=(*head, beta, unnormalized_head(beta, D)))
    entry = ("custereo_fused_pipeline_bwd_recompute" if free
             else "custereo_fused_pipeline_bwd")
    B, H, W = camera.shape
    grad = camera.new_empty((B, H, W))
    scratch = grad_scratch(camera, D)
    # K5's chunked route fills a slab of K1's costs (after the stream).
    slab = cost_slab(camera, "K5", D, k) if free else None
    with torch.cuda.device(camera.device):
        _build.launch(
            what, entry,
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch[:4]),
            *(ptr(v) for v in volume), *(ptr(m) for m in head),
            *(ptr(s) for s in scratch[4:]), ptr(grad), B, H, W, D, k,
            float(epsilon), float(beta), int(unnormalized_head(beta, D)),
            stream_of(camera.device),
            ptr_or_null(slab) if free else int(tile_rows),
            what=f"{what} fused pipeline backward launch")
    return grad


class _TrainablePipeline(torch.autograd.Function):
    """K3w forward and K4 backward (``save_volume``), the counterpart of
    ``_fused_train_v``; or K3m and K5, the counterpart of ``_fused_train``.
    The residuals are the images, the head's maps and, with
    ``save_volume``, the cost volume; the projector gets no gradient."""

    @staticmethod
    def forward(ctx, camera, projector, num_disparities, kernel_size,
                epsilon, beta, threshold, save_volume, tile, bwd_tile_rows):
        maps, res = fused_pipeline_train_cuda(
            camera, projector, num_disparities, kernel_size, epsilon, beta,
            threshold, save_volume, *tile)
        ctx.save_for_backward(camera, projector,
                              *(res if save_volume else res[:5]))
        ctx.args = (num_disparities, kernel_size, epsilon, beta,
                    bwd_tile_rows)
        ctx.mark_non_differentiable(maps.disparity, maps.mask)
        return tuple(maps)

    @staticmethod
    def backward(ctx, g_disparity, g_soft, g_mask, g_conf):
        camera, projector, *res = ctx.saved_tensors
        grad = fused_pipeline_bwd_cuda(camera, projector, HeadResiduals(*res),
                                       g_soft, g_conf, *ctx.args)
        return grad, None, None, None, None, None, None, None, None, None


def _check_trainable(camera: torch.Tensor) -> None:
    if camera.ndim != 3:
        raise ValueError(f"expected [B, H, W] images, got "
                         f"{tuple(camera.shape)}")


def stereo_pipeline_trainable(camera: torch.Tensor, projector: torch.Tensor,
                              num_disparities: int, kernel_size: int = 15,
                              epsilon: float = EPSILON, beta: float = 50.0,
                              threshold: float = 0.6,
                              save_volume: bool = True,
                              tile_rows: int = K_TILE_H, planes: int = 0,
                              bwd_tile_rows: int = K_TILE_H) -> PipelineMaps:
    """Differentiable fused pipeline: ``[B, H, W]`` pairs to four maps.

    With ``save_volume`` (the default) the forward (K3w) writes the cost
    volume as the backward's residual; without it the forward (K3m) writes
    only the maps and the backward (K5) recomputes each cost plane from the
    images, so no volume exists in device memory in either direction.  The
    backward forms the head cotangent plane by plane, so the cost-volume
    cotangent never exists in device memory.  Camera gradients flow through
    ``soft_disparity`` and ``confidence``; the projector gets none.
    ``(tile_rows, planes)`` is the forward's tile
    (:func:`fused_pipeline_train_cuda`), ``bwd_tile_rows`` K4's (K5 has
    none); the values are the same at every tile.
    """
    _check_trainable(camera)
    return PipelineMaps(*_TrainablePipeline.apply(
        camera, projector, int(num_disparities), int(kernel_size), epsilon,
        beta, threshold, bool(save_volume), (int(tile_rows), int(planes)),
        int(bwd_tile_rows)))


class _TrainableHead(torch.autograd.Function):
    """The plain head over a ``[B, H, W, D+1]`` volume, whose backward
    forms the cost cotangent explicitly with :func:`head_cotangent`."""

    @staticmethod
    def forward(ctx, cost, num_disparities, beta, threshold):
        am, conf, s, t = head_residuals(cost, num_disparities, beta)
        maps = _maps(am, conf, s, t, threshold)
        ctx.save_for_backward(cost, am, maps.mask, conf, s, t)
        ctx.args = (beta, unnormalized_head(beta, num_disparities))
        ctx.mark_non_differentiable(maps.disparity, maps.mask)
        return tuple(maps)

    @staticmethod
    def backward(ctx, g_disparity, g_soft, g_mask, g_conf):
        cost, am, mask, conf, s, t = ctx.saved_tensors
        return (head_cotangent(cost, am, mask, conf, s, t, g_soft, g_conf,
                               *ctx.args), None, None, None)


def stereo_pipeline_trainable_reference(camera: torch.Tensor,
                                        projector: torch.Tensor,
                                        num_disparities: int,
                                        kernel_size: int = 15,
                                        epsilon: float = EPSILON,
                                        beta: float = 50.0,
                                        threshold: float = 0.6,
                                        save_volume: bool = True,
                                        tile_rows: int = K_TILE_H,
                                        planes: int = 0,
                                        bwd_tile_rows: int = K_TILE_H
                                        ) -> PipelineMaps:
    """Plain twin of :func:`stereo_pipeline_trainable`: the closed-form
    volume op, then the head of :func:`head_cotangent`, each an autograd
    node.  ``save_volume`` and the tiles are accepted only to match the
    kernel node's signature: they choose what the kernels keep and how
    they cut the image, and the plain ops compute the same values and
    gradients either way."""
    _check_trainable(camera)
    COUNTS["plain.stereo_pipeline_trainable_reference"] += 1
    D = int(num_disparities)
    cost = StereoMatchingFunction.apply(camera, projector, D,
                                        int(kernel_size), epsilon)
    return PipelineMaps(*_TrainableHead.apply(cost, D, beta, threshold))
