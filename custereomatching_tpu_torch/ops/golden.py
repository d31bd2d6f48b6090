"""Golden (oracle) implementation of the ZNCC stereo cost volume, in torch.

The port's copy of ``custereomatching_tpu/ops/golden.py``: patch-based,
differentiable with ``torch.autograd``, runnable on the CPU and on the
card.  It is the direct definition, independent of the moments form the
plain versions (``ops/zncc.py``) and the kernels share: extract every
zero-padded k×k patch, subtract its mean, and sum the products.  So it is
a third oracle for the kernels beside their plain versions.

Semantics (the reference CUDA forward's):

* Out-of-bounds window reads are zero.
* Patch means divide by ``kernel_size**2`` *including* the zero padding.
* ``cost = (exy + eps) / sqrt(ex2*ey2 + eps)`` with ``eps = 1e-8``.
* All-pairs mode (``num_disparities=None``): ``[H, W, W]``, the last axis
  the absolute projector column.
* Banded mode: ``[H, W, D+1]``, band ``d`` correlating the camera patch at
  ``(h, w)`` with the projector patch centred at column ``w - d``
  (reads left of column 0 are zero).

Sums are plain fp32: elementwise products summed over the patch, and the
all-pairs contraction a ``torch.matmul`` that must not take TF32 (the JAX
oracle asks XLA for ``Precision.HIGHEST``); each function raises if
``torch.backends.cuda.matmul.allow_tf32`` is set.

The oracle is memory-hungry by design.  The banded volume materialises
the gathered and centred projector patches and their product with the
camera's: three ``[H, W, D+1, k²]`` float32 tensors of 4·H·W·(D+1)·k²
bytes each, and a gradient keeps about two more for its backward.  At
96×160, D = 64, k = 15 one is 0.90 GB.  On an 80 GB card the forward
stops fitting where H·W·(D+1)·k² passes about 6.7e9 and a gradient
where it passes about 4e9; at KITTI (375×1242, D = 192, k = 15) it is
2.0e10, one tensor alone 80.9 GB.  All-pairs holds ``[H, W, k²]``
patches and the ``[H, W, W]`` volume only.  Use it at small shapes;
``ops.zncc`` and the kernels are the fast paths.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

EPSILON = 1e-8


def _check_precision() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the golden oracle sums in full fp32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def extract_patches(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Extract zero-padded k×k patches around every pixel.

    Returns ``[H, W, k*k]`` where entry ``(h, w, i*k + j)`` is the pixel
    at ``(h + i - k//2, w + j - k//2)`` of the zero-padded image.
    """
    if img.ndim != 2:
        raise ValueError(f"expected [H, W] image, got shape "
                         f"{tuple(img.shape)}")
    k = kernel_size
    p = k // 2
    H, W = img.shape
    padded = F.pad(img, (p, p, p, p))
    shifts = [padded[i:i + H, j:j + W] for i in range(k) for j in range(k)]
    return torch.stack(shifts, dim=-1)


def zncc_cost_volume(camera: torch.Tensor, projector: torch.Tensor,
                     num_disparities: Optional[int] = None,
                     kernel_size: int = 15,
                     epsilon: float = EPSILON) -> torch.Tensor:
    """ZNCC cost volume, oracle implementation.

    Args:
      camera: ``[H, W]`` float image.
      projector: ``[H, W]`` float image (same shape).
      num_disparities: ``None`` → all-pairs ``[H, W, W]``; integer ``D``
        → banded ``[H, W, D+1]``.
      kernel_size: odd window side ``k``.
      epsilon: numerical epsilon (see the module docstring).
    """
    _check_precision()
    if camera.shape != projector.shape:
        raise ValueError(f"camera {tuple(camera.shape)} and projector "
                         f"{tuple(projector.shape)} must match")
    k = kernel_size
    H, W = camera.shape

    camp = extract_patches(camera, k)
    camc = camp - camp.mean(dim=-1, keepdim=True)
    ex2 = (camc * camc).sum(dim=-1)  # [H, W]

    if num_disparities is None:
        projp = extract_patches(projector, k)
        projc = projp - projp.mean(dim=-1, keepdim=True)
        ey2 = (projc * projc).sum(dim=-1)  # [H, W], by absolute column
        exy = torch.matmul(camc, projc.transpose(1, 2))  # [H, W, W]
        deno = torch.sqrt(ex2[:, :, None] * ey2[:, None, :] + epsilon)
        return (exy + epsilon) / deno

    D = num_disparities
    # Left-extend the projector by D zero columns so that a patch centred
    # at column (w - d) is always a valid gather; the zeros are the
    # out-of-bounds reads left of column 0.
    projp_ext = extract_patches(F.pad(projector, (D, 0)), k)  # [H, W+D, k2]
    # band gather: extended column (w - d) + D
    idx = (torch.arange(W, device=camera.device)[:, None]
           - torch.arange(D + 1, device=camera.device)[None, :]) + D
    projp_band = projp_ext[:, idx, :]  # [H, W, D+1, k2]
    projc_band = projp_band - projp_band.mean(dim=-1, keepdim=True)
    ey2_band = (projc_band * projc_band).sum(dim=-1)  # [H, W, D+1]
    exy = (camc[:, :, None, :] * projc_band).sum(dim=-1)
    deno = torch.sqrt(ex2[:, :, None] * ey2_band + epsilon)
    return (exy + epsilon) / deno


def _vjp(camera: torch.Tensor, projector: torch.Tensor,
         cost_volume_grad: torch.Tensor, num_disparities: Optional[int],
         kernel_size: int, epsilon: float, wrt: int) -> torch.Tensor:
    inputs = [camera.detach().requires_grad_(wrt == 0),
              projector.detach().requires_grad_(wrt == 1)]
    with torch.enable_grad():
        cv = zncc_cost_volume(inputs[0], inputs[1], num_disparities,
                              kernel_size, epsilon)
        (grad,) = torch.autograd.grad(
            torch.sum(cv * cost_volume_grad), inputs[wrt])
    return grad


def zncc_camera_grad(camera: torch.Tensor, projector: torch.Tensor,
                     cost_volume_grad: torch.Tensor,
                     num_disparities: Optional[int] = None,
                     kernel_size: int = 15,
                     epsilon: float = EPSILON) -> torch.Tensor:
    """Oracle camera-image gradient: ``torch.autograd.grad`` of
    ``sum(cost_volume * cost_volume_grad)`` through the oracle forward."""
    return _vjp(camera, projector, cost_volume_grad, num_disparities,
                kernel_size, epsilon, 0)


def zncc_projector_grad(camera: torch.Tensor, projector: torch.Tensor,
                        cost_volume_grad: torch.Tensor,
                        num_disparities: Optional[int] = None,
                        kernel_size: int = 15,
                        epsilon: float = EPSILON) -> torch.Tensor:
    """Oracle projector-image gradient, by autograd as the camera's."""
    return _vjp(camera, projector, cost_volume_grad, num_disparities,
                kernel_size, epsilon, 1)


__all__ = ["EPSILON", "extract_patches", "zncc_camera_grad",
           "zncc_cost_volume", "zncc_projector_grad"]
