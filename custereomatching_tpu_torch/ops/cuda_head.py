"""Wrappers of kernel K8h, the disparity head over a written cost volume
on the card, and K8hb, its VJP, and their autograd node.

The kernels are ``csrc/volume_head.cu``.  They replace no TPU kernel: the
JAX package leaves the head (``ops/disparity.py::extract_disparity``) to
XLA.  Bytes bound them: K8h reads the volume once, K8hb reads it once and
writes its cotangent once, where the plain head makes about ten passes
over it forward and as many through autograd.  A CPU tensor takes the
plain :func:`.disparity.extract_disparity`; a CUDA tensor launches the
kernels or the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    extract_disparity,
)


def _check_volume(cost: torch.Tensor, num_disparities: Optional[int],
                  beta: float) -> bool:
    """Raise ``ValueError`` for a volume the kernels do not take: other
    than a float32 ``[H, W, L]`` or ``[B, H, W, L]`` with L >= 1 (L = D +
    1 banded), contiguous (K8's) or the ``[..., H, W, L]`` view of a
    contiguous ``[..., L, H, W]`` (K1's), or beta <= 0.  Returns whether
    the kernels walk it plane-major (K1's layout)."""
    if cost.ndim not in (3, 4):
        raise ValueError(f"expected [H, W, L] or [B, H, W, L] volume, got "
                         f"{tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise ValueError(f"K8h: expected a float32 volume, got {cost.dtype}")
    if cost.is_contiguous():
        plane_major = False
    elif cost.movedim(-1, -3).is_contiguous():
        plane_major = True
    else:
        raise ValueError(f"K8h: expected a contiguous volume or the view of "
                         f"a contiguous plane-major one, got strides "
                         f"{cost.stride()} (strided)")
    L = cost.shape[-1]
    if L < 1:
        raise ValueError("K8h: the volume's last axis is empty")
    if num_disparities is not None and L != num_disparities + 1:
        raise ValueError(f"banded volume last axis {L} != num_disparities+1 "
                         f"({num_disparities + 1})")
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    return plane_major


def _head_forward(cost: torch.Tensor, num_disparities: Optional[int],
                  threshold: float, beta: float, plane_major: bool
                  ) -> Tuple[DisparityResult, torch.Tensor]:
    """K8h: the four maps and the residuals ``[3, ...]`` K8hb reads (s,
    corr and the count of entries tied at the maximum) of a volume
    :func:`_check_volume` passed, in its layout."""
    H, W, L = cost.shape[-3:]
    shape = cost.shape[:-1]
    # Four tensors, not views of one: each is an output of the node.
    maps = DisparityResult(cost.new_empty(shape), cost.new_empty(shape),
                           cost.new_empty(shape), cost.new_empty(shape))
    resid = cost.new_empty((3,) + shape)
    pixels = cost.numel() // L
    if pixels:
        with torch.cuda.device(cost.device):
            _build.launch(
                "K8h", "custereo_volume_head", ptr(cost), ptr(maps[0]),
                ptr(maps[1]), ptr(maps[2]), ptr(maps[3]), ptr(resid),
                pixels, H * W, W, L, beta, threshold,
                int(num_disparities is None), int(plane_major),
                stream_of(cost.device), what="K8h volume head launch")
    return maps, resid


def _head_vjp(cost: torch.Tensor, conf: torch.Tensor, resid: torch.Tensor,
              g_soft: Optional[torch.Tensor], g_conf: Optional[torch.Tensor],
              all_pairs: bool, threshold: float, beta: float,
              plane_major: bool) -> torch.Tensor:
    """K8hb: the cost cotangent that ``g_soft`` and ``g_conf`` (either
    None: no cotangent) induce,

        g_c[j] = beta g_corr / s * e[j] * (j - corr)
               + (c[j] == m) g_conf / ties,

    ``e[j] = exp(beta c[j] - beta m)``, ``g_corr = -mask g_soft``
    all-pairs and ``+mask g_soft`` banded: the softmax's and the sum's VJP
    in closed form, and amax's, which splits ``g_conf`` evenly over a tie
    as torch's does.  The cotangent takes the volume's layout."""
    g_soft = None if g_soft is None else g_soft.contiguous()
    g_conf = None if g_conf is None else g_conf.contiguous()
    # empty_like keeps a dense tensor's strides, so a plane-major volume's
    # cotangent is one too: K2's and K7's layout.
    out = torch.empty_like(cost)
    H, W, L = cost.shape[-3:]
    pixels = cost.numel() // L
    if pixels:
        with torch.cuda.device(cost.device):
            _build.launch(
                "K8hb", "custereo_volume_head_grad", ptr(cost), ptr(conf),
                ptr(resid), None if g_soft is None else ptr(g_soft),
                None if g_conf is None else ptr(g_conf), ptr(out), pixels,
                H * W, L, beta, threshold, int(all_pairs), int(plane_major),
                stream_of(cost.device), what="K8hb volume head VJP launch")
    return out


class VolumeHead(torch.autograd.Function):
    """K8h as an autograd node whose backward is K8hb, over a CUDA volume.
    The residuals are the volume, the confidence and K8h's ``[3, ...]``
    (s, corr, ties); the layout is read once, forward.  The hard map and
    the mask carry no gradient, and an output the loss does not use gives
    no cotangent (``None``, not zeros)."""

    @staticmethod
    def forward(ctx, cost, num_disparities, threshold, beta):
        plane_major = _check_volume(cost, num_disparities, beta)
        maps, resid = _head_forward(cost, num_disparities, threshold, beta,
                                    plane_major)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(maps.disparity, maps.mask)
        ctx.save_for_backward(cost, maps.confidence, resid)
        ctx.args = (num_disparities is None, threshold, beta, plane_major)
        return tuple(maps)

    @staticmethod
    def backward(ctx, g_disparity, g_soft, g_mask, g_conf):
        if not ctx.needs_input_grad[0] or (g_soft is None
                                           and g_conf is None):
            return None, None, None, None
        cost, conf, resid = ctx.saved_tensors
        return (_head_vjp(cost, conf, resid, g_soft, g_conf, *ctx.args),
                None, None, None)


def extract_disparity_cuda(cost_volume: torch.Tensor,
                           num_disparities: Optional[int] = None,
                           threshold: float = 0.6,
                           beta: float = 50.0) -> DisparityResult:
    """:func:`.disparity.extract_disparity` on the card: K8h forward and
    K8hb backward over a float32 ``[H, W, L]`` or ``[B, H, W, L]`` volume,
    all-pairs (``num_disparities`` None, L = W) or banded (L = D + 1),
    contiguous (K8's) or the view of a contiguous plane-major one (K1's);
    anything else on a CUDA tensor raises ``ValueError``, as does beta <=
    0.  The hard map, the mask and the confidence are the plain head's
    bit for bit; the soft map and the gradient differ by the order of the
    sums.  A CPU tensor takes the plain head."""
    if cost_volume.device.type == "cpu":
        return extract_disparity(cost_volume, num_disparities, threshold,
                                 beta)
    if cost_volume.device.type != "cuda":
        raise ValueError(f"K8h runs on CUDA or (plain) CPU tensors, got "
                         f"{cost_volume.device}")
    return DisparityResult(*VolumeHead.apply(
        cost_volume, num_disparities, float(threshold), float(beta)))
