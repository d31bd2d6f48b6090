"""Plain PyTorch banded ZNCC cost volume.

The twin of ``custereomatching_tpu/ops/zncc.py`` (``box2d``,
``_image_moments``, ``_banded_stats``, ``_forward_banded``): the CPU
backend of the port, and the plain version that the CUDA kernel K1
(``csrc/zncc_banded.cu``) is held against on the card.

Numerical contract: windows read zeros outside the image, means divide
by k^2 including the padding, and
``cost = (exy + eps) / sqrt(ex2 * ey2 + eps)`` in fp32.

Window sums are k shifted-slice adds over a zero-padded tensor, rows then
columns.  ``F.conv2d`` is avoided on purpose: cuDNN runs fp32
convolutions in TF32 by default, which would spoil every comparison on
the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

EPSILON = 1e-8

ALLPAIRS_TODO = ("the all-pairs [H, W, W] volume (num_disparities=None) is "
                 "not ported yet: ROADMAP item 9")


def _box_axis(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """k-tap zero-padded ("same") windowed sum along ``dim``."""
    p = k // 2
    n = x.shape[dim]
    if p:
        zeros = x.new_zeros(x.shape[:dim] + (p,) + x.shape[dim + 1:])
        x = torch.cat([zeros, x, zeros], dim=dim)
    out = x.narrow(dim, 0, n).clone()
    for t in range(1, k):
        out += x.narrow(dim, t, n)
    return out


def box2d(x: torch.Tensor, k: int, dim: int = 0) -> torch.Tensor:
    """k x k windowed sum over axes ``dim`` and ``dim + 1``, zero-padded.

    ``out[h, w] = sum_{|i|, |j| <= k//2} x[h+i, w+j]`` with out-of-bounds
    terms zero.  With the default ``dim=0`` this is the JAX ``box2d``
    (leading two axes; trailing axes have window 1).
    """
    dim = dim % x.ndim
    return _box_axis(_box_axis(x, k, dim), k, dim + 1)


def _image_moments(img: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window sum S and centered second moment E2 = sum (x - mu)^2 of a
    ``[B, H, W]`` batch, for every window center."""
    k2 = float(k * k)
    s = box2d(img, k, dim=1)
    s2 = box2d(img * img, k, dim=1)
    return s, s2 - s * s / k2


def _band_index(W: int, D: int, device: torch.device) -> torch.Tensor:
    """[W, D+1] indices into a left-extended (by D) column axis: entry
    (w, d) addresses original column (w - d), always in range."""
    w = torch.arange(W, device=device)[:, None]
    d = torch.arange(D + 1, device=device)[None, :]
    return w - d + D


def _banded_stats(camera: torch.Tensor, projector: torch.Tensor, D: int,
                  k: int):
    """Window statistics of the banded forward, for ``[B, H, W]`` pairs;
    the band tensors are ``[B, H, W, D+1]``."""
    k2 = float(k * k)
    sx, ex2 = _image_moments(camera, k)
    # Left-extend the projector by D zero columns so column (w - d) is a
    # plain gather; the zeros reproduce the out-of-image reads.
    proj_ext = F.pad(projector, (D, 0))
    sy_ext, ey2_ext = _image_moments(proj_ext, k)
    idx = _band_index(camera.shape[-1], D, camera.device)
    proj_band = proj_ext[:, :, idx]
    sy_band = sy_ext[:, :, idx]
    ey2_band = ey2_ext[:, :, idx]
    sxy = box2d(camera[..., None] * proj_band, k, dim=1)
    exy = sxy - sx[..., None] * sy_band / k2
    return sx, ex2, sy_band, ey2_band, proj_band, exy, k2


def forward_banded(camera: torch.Tensor, projector: torch.Tensor,
                   num_disparities: int, kernel_size: int = 15,
                   epsilon: float = EPSILON) -> torch.Tensor:
    """Banded cost volume of ``[B, H, W]`` pairs: ``[B, H, W, D+1]``, band
    d matching projector column ``w - d``.

    The plain version of K1 (the JAX ``_forward_banded``); ``.calls``
    counts its uses."""
    forward_banded.calls += 1
    _, ex2, _, ey2_band, _, exy, _ = _banded_stats(
        camera, projector, int(num_disparities), int(kernel_size))
    deno = torch.sqrt(ex2[..., None] * ey2_band + epsilon)
    return (exy + epsilon) / deno


forward_banded.calls = 0


def check_pair(camera: torch.Tensor, projector: torch.Tensor,
               kernel_size: int, min_kernel_size: int = 1) -> None:
    """Validate a stereo pair of matching ``[H, W]`` or ``[B, H, W]``
    images and an odd window size."""
    if camera.ndim not in (2, 3) or camera.shape != projector.shape:
        raise ValueError(
            f"expected matching [H, W] or [B, H, W] images, got "
            f"{tuple(camera.shape)} vs {tuple(projector.shape)}")
    if kernel_size < min_kernel_size or kernel_size % 2 != 1:
        raise ValueError(
            f"kernel_size must be odd and >= {min_kernel_size}, got "
            f"{kernel_size}")


def stereo_matching_torch(camera: torch.Tensor, projector: torch.Tensor,
                          num_disparities: Optional[int],
                          kernel_size: int = 15,
                          epsilon: float = EPSILON) -> torch.Tensor:
    """The plain banded ZNCC op on any device: ``[H, W]`` or ``[B, H, W]``
    pairs to ``[..., H, W, D+1]`` volumes.

    Differentiable in the camera through autograd; the projector is
    detached, so it receives no gradient (the JAX op's camera-only
    contract).  k = 1 is accepted, as in the JAX XLA op.
    """
    check_pair(camera, projector, kernel_size)
    if num_disparities is None:
        raise NotImplementedError(ALLPAIRS_TODO)
    if num_disparities < 0:
        raise ValueError(f"num_disparities must be >= 0, got "
                         f"{num_disparities}")
    single = camera.ndim == 2
    if single:
        camera, projector = camera[None], projector[None]
    cost = forward_banded(camera, projector.detach(), num_disparities,
                          kernel_size, epsilon)
    return cost[0] if single else cost
