"""Disparity extraction from ZNCC cost volumes (PyTorch port).

The twin of ``custereomatching_tpu/ops/disparity.py``:

  * all-pairs volumes ``[H, W, W]``: the last axis is the absolute
    projector column, so ``disparity = w - correspondence``;
  * banded volumes ``[H, W, D+1]``: the band index is the disparity;
  * plane-major volumes ``[B, D+1, H, W]`` (:func:`extract_disparity_hdw`):
    the plane index is the disparity;
  * ``mask = max_d cost > threshold``; masked pixels get disparity 0.

``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DisparityResult(NamedTuple):
    """Outputs of the disparity head (each ``[..., H, W]``).

    Attributes:
      disparity: hard (integer-valued float) disparity, masked.
      soft_disparity: differentiable sub-pixel disparity, masked.
      mask: confidence mask (1.0 where max correlation exceeds the
        threshold).
      confidence: per-pixel maximum correlation value.
    """

    disparity: torch.Tensor
    soft_disparity: torch.Tensor
    mask: torch.Tensor
    confidence: torch.Tensor


def soft_argmax(x: torch.Tensor, beta: float = 50.0,
                dim: int = -1) -> torch.Tensor:
    """Differentiable argmax: ``sum_i softmax(beta x)_i * i`` along ``dim``."""
    weights = torch.softmax(x * beta, dim=dim)
    indices = torch.arange(x.shape[dim], dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    return torch.sum(weights * indices.reshape(shape), dim=dim)


def extract_disparity(cost_volume: torch.Tensor,
                      num_disparities: Optional[int] = None,
                      threshold: float = 0.6,
                      beta: float = 50.0) -> DisparityResult:
    """Full disparity head: mask, argmax / soft-argmax, disparity.

    Args:
      cost_volume: ``[H, W, L]`` or batched ``[B, H, W, L]`` ZNCC volume.
      num_disparities: None if the volume is all-pairs (last axis =
        absolute projector column); the band size D if banded.
      threshold: confidence threshold on the per-pixel max correlation.
      beta: soft-argmax temperature.
    """
    if cost_volume.ndim not in (3, 4):
        raise ValueError(
            f"expected [H, W, L] or [B, H, W, L] volume, got "
            f"{tuple(cost_volume.shape)}")
    W, L = cost_volume.shape[-2:]
    dtype = cost_volume.dtype

    confidence = torch.amax(cost_volume, dim=-1)
    mask = (confidence > threshold).to(dtype)
    corr_hard = torch.argmax(cost_volume, dim=-1).to(dtype)
    corr_soft = soft_argmax(cost_volume, beta=beta, dim=-1)

    if num_disparities is None:
        template = torch.arange(W, dtype=dtype, device=cost_volume.device)
        disparity = (template - corr_hard) * mask
        soft_disparity = (template - corr_soft) * mask
    else:
        if L != num_disparities + 1:
            raise ValueError(
                f"banded volume last axis {L} != num_disparities+1 "
                f"({num_disparities + 1})")
        disparity = corr_hard * mask
        soft_disparity = corr_soft * mask

    return DisparityResult(disparity=disparity, soft_disparity=soft_disparity,
                           mask=mask, confidence=confidence)


def extract_disparity_hdw(cost_volume_hdw: torch.Tensor,
                          num_disparities: int, height: int, width: int,
                          threshold: float = 0.6,
                          beta: float = 50.0) -> DisparityResult:
    """Disparity head over a plane-major volume, the counterpart of the JAX
    ``extract_disparity_hdw``.

    Takes the port's exact ``[B, D+1, H, W]`` volume (what K1 and K3w
    write) or ``[D+1, H, W]``, and also padded volumes with more planes,
    rows or columns.  Reduces over the plane axis (``-3``) with the planes
    beyond D masked to -3e38, so they move neither the max nor the
    softmax, then crops the maps to ``[..., height, width]``.  A training
    loss therefore needs no permute, and padded entries get an exactly
    zero cotangent.
    """
    if cost_volume_hdw.ndim not in (3, 4):
        raise ValueError(
            f"expected [D+1, H, W] or [B, D+1, H, W] volume, got "
            f"{tuple(cost_volume_hdw.shape)}")
    ndt = cost_volume_hdw.shape[-3]
    if ndt < num_disparities + 1:
        raise ValueError(f"volume has {ndt} planes < num_disparities+1 "
                         f"({num_disparities + 1})")
    dtype, device = cost_volume_hdw.dtype, cost_volume_hdw.device
    plane = torch.arange(ndt, device=device)[:, None, None]
    masked = torch.where(plane <= num_disparities, cost_volume_hdw,
                         torch.tensor(-3.0e38, dtype=dtype, device=device))

    confidence = torch.amax(masked, dim=-3)[..., :height, :width]
    mask = (confidence > threshold).to(dtype)
    corr_hard = torch.argmax(masked, dim=-3).to(dtype)[..., :height, :width]
    corr_soft = soft_argmax(masked, beta=beta, dim=-3)[..., :height, :width]
    return DisparityResult(disparity=corr_hard * mask,
                           soft_disparity=corr_soft * mask,
                           mask=mask, confidence=confidence)


def disparity_to_depth(disparity: torch.Tensor, focal_length: float,
                       baseline: float,
                       min_disparity: float = 1e-3) -> torch.Tensor:
    """Convert a disparity map to metric depth: ``Z = f * b / d``.

    Pixels with disparity below ``min_disparity`` (including masked-out
    zeros) map to depth 0.
    """
    safe = torch.clamp_min(disparity, min_disparity)
    depth = focal_length * baseline / safe
    return torch.where(disparity >= min_disparity, depth,
                       torch.zeros_like(depth))
