"""Plain ZNCC cost volumes and the disparity head, one frame at a time.

The benchmark's own reference, written from the definition and not from
the program (it imports nothing of the port):

  * windows are k x k, read zeros outside the image, and their means
    divide by k^2 padding included;
  * ``cost = (exy + eps) / sqrt(ex2 * ey2 + eps)`` with the window sums
    ``exy = sxy - sx sy / k^2`` and ``ex2 = sxx - sx^2 / k^2``;
  * banded: plane d matches projector column ``w - d`` (the projector's
    own window there, zero left of the image); all-pairs: the last axis
    is the absolute projector column;
  * the head: the largest cost (confidence), its first index (hard),
    ``sum_i softmax(beta c)_i i`` (soft), and the mask ``confidence >
    threshold``; all-pairs disparities are ``w - index``.

Window sums are shifted-slice adds, rows then columns; the all-pairs row
products are a batched matrix product.  Every function computes in the
dtype of its inputs: float64 for the reference, bfloat16 for the control
(``checks.py``).  A matrix product in float32 would be TF32 under the
global flags, so :func:`exact_matmul` turns them off around it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch


@contextlib.contextmanager
def exact_matmul():
    """Matrix products at their dtype's own precision (no TF32)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """k-tap zero-padded window sum along ``dim``."""
    p = k // 2
    n = x.shape[dim]
    if p:
        shape = list(x.shape)
        shape[dim] = p
        z = x.new_zeros(shape)
        x = torch.cat([z, x, z], dim=dim)
    out = x.narrow(dim, 0, n).clone()
    for t in range(1, k):
        out = out + x.narrow(dim, t, n)
    return out


def box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sum over the first two axes (rows, columns)."""
    return window_sum(window_sum(x, k, 0), k, 1)


def moments(img: torch.Tensor, k: int):
    """Window sum and centred window sum of squares of an ``[H, W']``
    image."""
    s = box(img, k)
    return s, box(img * img, k) - s * s / float(k * k)


def banded_volume(cam: torch.Tensor, proj: torch.Tensor, D: int, k: int,
                  eps: float) -> torch.Tensor:
    """``[H, W, D+1]`` costs of one ``[H, W]`` pair."""
    H, W = cam.shape
    k2 = float(k * k)
    sx, ex2 = moments(cam, k)
    ext = torch.cat([proj.new_zeros((H, D)), proj], dim=1)  # col c -> c - D
    sy, ey2 = moments(ext, k)
    idx = (torch.arange(W, device=cam.device)[:, None]
           - torch.arange(D + 1, device=cam.device)[None, :] + D)
    sxy = box(cam[:, :, None] * ext[:, idx], k)
    exy = sxy - sx[:, :, None] * sy[:, idx] / k2
    return (exy + eps) * torch.rsqrt(ex2[:, :, None] * ey2[:, idx] + eps)


def allpairs_volume(cam: torch.Tensor, proj: torch.Tensor, k: int,
                    eps: float) -> torch.Tensor:
    """``[H, W, W]`` costs of one ``[H, W]`` pair."""
    H, W = cam.shape
    p = k // 2
    k2 = float(k * k)
    sx, ex2 = moments(cam, k)
    sy, ey2 = moments(proj, k)

    def hankel(img):          # [H, W, k]: img[h, w + j - p], zero outside
        padded = torch.cat([img.new_zeros((H, p)), img,
                            img.new_zeros((H, p))], dim=1)
        return torch.stack([padded[:, j:j + W] for j in range(k)], dim=-1)

    with exact_matmul():
        rows = torch.matmul(hankel(cam), hankel(proj).transpose(1, 2))
    sxy = window_sum(rows, k, 0)
    exy = sxy - sx[:, :, None] * sy[:, None, :] / k2
    return (exy + eps) * torch.rsqrt(ex2[:, :, None] * ey2[:, None, :] + eps)


def volume(cam: torch.Tensor, proj: torch.Tensor, config: dict
           ) -> torch.Tensor:
    """The configuration's volume of one pair: banded where it states
    ``num_disparities``, all-pairs where that is null."""
    k, eps = int(config["kernel_size"]), float(config["epsilon"])
    if config["num_disparities"] is None:
        return allpairs_volume(cam, proj, k, eps)
    return banded_volume(cam, proj, int(config["num_disparities"]), k, eps)


class Head(NamedTuple):
    confidence: torch.Tensor   # [H, W] largest cost
    index: torch.Tensor        # [H, W] first index of it (long)
    soft: torch.Tensor         # [H, W] soft disparity, not masked
    mask: torch.Tensor         # [H, W] confidence > threshold (bool)


def head(vol: torch.Tensor, config: dict) -> Head:
    """The disparity head over one ``[H, W, L]`` volume."""
    beta = float(config["softargmax_beta"])
    conf = torch.amax(vol, dim=-1)
    index = torch.argmax(vol, dim=-1)
    weights = torch.softmax(vol * beta, dim=-1)
    planes = torch.arange(vol.shape[-1], device=vol.device, dtype=vol.dtype)
    soft = torch.sum(weights * planes, dim=-1)
    if config["num_disparities"] is None:
        cols = torch.arange(vol.shape[1], device=vol.device, dtype=vol.dtype)
        soft = cols[None, :] - soft
    return Head(confidence=conf, index=index, soft=soft,
                mask=conf > float(config["cost_threshold"]))


def disparity_of_index(index: torch.Tensor, config: dict) -> torch.Tensor:
    """Hard disparity of a volume index (banded: the index; all-pairs:
    ``w - index``)."""
    if config["num_disparities"] is None:
        cols = torch.arange(index.shape[-1], device=index.device)
        return cols - index
    return index


def index_of_disparity(disp: torch.Tensor, config: dict) -> torch.Tensor:
    """Volume index of a hard disparity map (the inverse of
    :func:`disparity_of_index`), as long."""
    d = torch.round(disp).to(torch.int64)
    if config["num_disparities"] is None:
        cols = torch.arange(disp.shape[-1], device=disp.device)
        return cols - d
    return d


def used_mask(ref_mask: torch.Tensor, confidence: torch.Tensor,
              other: Optional[torch.Tensor], threshold: float,
              tie: float) -> torch.Tensor:
    """The reference's mask, with the judged side's choice taken where the
    reference's confidence lies within ``tie`` of the threshold: there
    either choice is right to rounding."""
    if other is None:
        return ref_mask
    near = (confidence - threshold).abs() <= tie
    return torch.where(near, other, ref_mask)
