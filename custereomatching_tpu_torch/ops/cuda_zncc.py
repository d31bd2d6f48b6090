"""Wrappers of kernels K1, K2, K6 and K7: the banded ZNCC cost volume on
the card, its camera VJP with and without the cost residual, and its
projector VJP.

The counterparts of ``custereomatching_tpu/ops/pallas_zncc.py`` and of
``pallas_zncc_bwd.py``.  The kernels are ``csrc/zncc_banded.cu`` (K1),
``csrc/zncc_banded_bwd.cu`` (K2 and K6) and ``csrc/zncc_banded_proj_bwd.cu``
(K7); their plain versions are :func:`.zncc.forward_banded`,
:func:`.zncc.camera_grad_banded` (for K2 and K6) and
:func:`.zncc.projector_grad_banded`.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.layout import parity_to_plane_major
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    camera_grad_banded,
    check_pair,
    forward_banded,
    projector_grad_banded,
)

# The kernel path rejects k < 3 (the JAX Pallas kernels do too): k = 1 is
# the degenerate no-window case, which the plain op keeps.
MIN_KERNEL_SIZE = 3


def prepare(camera: torch.Tensor, projector: torch.Tensor,
            num_disparities: int, kernel_size: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate a ``[B, H, W]`` fp32 pair for the kernels; returns it
    contiguous."""
    check_pair(camera, projector, kernel_size, MIN_KERNEL_SIZE)
    if camera.ndim != 3:
        raise ValueError(f"expected [B, H, W] images, got "
                         f"{tuple(camera.shape)}")
    if min(camera.shape) < 1:
        raise ValueError(f"empty images {tuple(camera.shape)}")
    if camera.dtype != torch.float32 or projector.dtype != torch.float32:
        raise ValueError(f"expected float32 images, got {camera.dtype} and "
                         f"{projector.dtype}")
    if camera.device != projector.device:
        raise ValueError(f"images on different devices: {camera.device} vs "
                         f"{projector.device}")
    if int(num_disparities) < 0:
        raise ValueError(f"num_disparities must be >= 0, got "
                         f"{num_disparities}")
    return camera.contiguous(), projector.contiguous()


def stats_scratch(camera: torch.Tensor, num_disparities: int):
    """Window-statistics scratch of the kernels: camera sum and second
    moment ``[B, H, W]``, projector sum and second moment over the
    D-widened columns ``[B, H, W + D]``."""
    B, H, W = camera.shape
    cam = camera.new_empty((2, B, H, W))
    proj = camera.new_empty((2, B, H, W + num_disparities))
    return cam[0], cam[1], proj[0], proj[1]


def cost_volume_banded_cuda(camera: torch.Tensor, projector: torch.Tensor,
                            num_disparities: int, kernel_size: int = 15,
                            epsilon: float = EPSILON) -> torch.Tensor:
    """Banded ZNCC volume of ``[B, H, W]`` pairs: ``[B, H, W, D+1]``.

    On a CUDA tensor this launches K1, which writes the volume
    plane-major ``[B, D+1, H, W]``; the result is a permuted view of it.
    ``.launches`` counts the kernel's launches.
    """
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    if camera.device.type == "cpu":
        return forward_banded(camera, projector, D, k, epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    lib = _build.kernels()
    B, H, W = camera.shape
    out = camera.new_empty((B, D + 1, H, W))
    scratch = stats_scratch(camera, D)
    with torch.cuda.device(camera.device):
        code = lib.custereo_banded_volume(
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch),
            ptr(out), B, H, W, D, k, float(epsilon),
            stream_of(camera.device))
    _build.check(code, "K1 banded volume launch")
    cost_volume_banded_cuda.launches += 1
    return out.permute(0, 2, 3, 1)


cost_volume_banded_cuda.launches = 0


def check_volume(volume: torch.Tensor, camera: torch.Tensor,
                 num_disparities: int, what: str) -> torch.Tensor:
    """Validate a plane-major ``[B, D+1, H, W]`` fp32 volume that belongs
    with ``[B, H, W]`` images; returns it contiguous."""
    B, H, W = camera.shape
    want = (B, int(num_disparities) + 1, H, W)
    if tuple(volume.shape) != want:
        raise ValueError(f"{what}: expected a plane-major volume {want}, "
                         f"got {tuple(volume.shape)}")
    if volume.dtype != torch.float32 or volume.device != camera.device:
        raise ValueError(f"{what}: expected float32 on {camera.device}, got "
                         f"{volume.dtype} on {volume.device}")
    return volume.contiguous()


def grad_scratch(camera: torch.Tensor, num_disparities: int):
    """Scratch of the camera-VJP kernels (K2, K4, K5, K6): the statistics of
    :func:`stats_scratch`, then the A1, B and GRMU fields ``[B, H, W]``."""
    fields = camera.new_empty((3,) + tuple(camera.shape))
    return stats_scratch(camera, num_disparities) + tuple(fields.unbind(0))


def camera_grad_banded_cuda(camera: torch.Tensor, projector: torch.Tensor,
                            cost: Optional[torch.Tensor],
                            cotangent: torch.Tensor,
                            num_disparities: int, kernel_size: int = 15,
                            epsilon: float = EPSILON) -> torch.Tensor:
    """Camera VJP of the banded volume: ``[B, H, W]`` pairs, the forward
    volume (or None) and its cotangent, both plane-major
    ``[B, D+1, H, W]``, to a ``[B, H, W]`` gradient; with ``cost=None`` the
    JAX ``pallas_camera_grad_banded_hdw``, else its ``_with_cost`` form.

    On a CUDA tensor this launches K2, which reads the cost as a residual
    (``n r = c``: no cross-term recompute), or, with ``cost=None``, K6,
    which recomputes each cost plane from the images.  A CPU tensor takes
    the plain closed form, which recomputes the cost.  ``.launches`` counts
    K2's launches and ``.recompute_launches`` K6's.
    """
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    what = "K6" if cost is None else "K2"
    cotangent = check_volume(cotangent, camera, D, f"{what} cotangent")
    volume = () if cost is None else (check_volume(cost, camera, D,
                                                   "K2 cost"),)
    if camera.device.type == "cpu":
        return camera_grad_banded(camera, projector,
                                  cotangent.permute(0, 2, 3, 1), D, k,
                                  epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    lib = _build.kernels()
    entry = (lib.custereo_camera_grad_recompute if cost is None
             else lib.custereo_camera_grad)
    B, H, W = camera.shape
    grad = camera.new_empty((B, H, W))
    scratch = grad_scratch(camera, D)
    with torch.cuda.device(camera.device):
        code = entry(
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch[:4]),
            *(ptr(v) for v in volume), ptr(cotangent),
            *(ptr(s) for s in scratch[4:]), ptr(grad), B, H, W, D, k,
            float(epsilon), stream_of(camera.device))
    _build.check(code, f"{what} camera VJP launch")
    if cost is None:
        camera_grad_banded_cuda.recompute_launches += 1
    else:
        camera_grad_banded_cuda.launches += 1
    return grad


camera_grad_banded_cuda.launches = 0
camera_grad_banded_cuda.recompute_launches = 0


def camera_grad_banded_parity_cuda(camera: torch.Tensor,
                                   projector: torch.Tensor,
                                   cotangent: torch.Tensor,
                                   num_disparities: int,
                                   kernel_size: int = 15,
                                   epsilon: float = EPSILON) -> torch.Tensor:
    """Camera VJP of the banded volume from a parity ``[B, H, W, D+1]``
    cotangent, with no forward volume (the JAX
    ``pallas_camera_grad_banded``): on a CUDA tensor K9b stages the
    cotangent plane-major, then K6 runs.  A CPU tensor takes the plain
    closed form on the cotangent as it is."""
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    want = tuple(camera.shape) + (D + 1,)
    if tuple(cotangent.shape) != want:
        raise ValueError(f"K6 cotangent: expected a parity volume {want}, "
                         f"got {tuple(cotangent.shape)}")
    if camera.device.type == "cpu":
        return camera_grad_banded(camera, projector, cotangent, D, k,
                                  epsilon)
    return camera_grad_banded_cuda(camera, projector, None,
                                   parity_to_plane_major(cotangent), D, k,
                                   epsilon)


def projector_grad_banded_cuda(camera: torch.Tensor, projector: torch.Tensor,
                               cost: torch.Tensor, cotangent: torch.Tensor,
                               num_disparities: int, kernel_size: int = 15,
                               epsilon: float = EPSILON) -> torch.Tensor:
    """Projector VJP of the banded volume: ``[B, H, W]`` pairs, the forward
    volume and its cotangent, both plane-major ``[B, D+1, H, W]``, to a
    ``[B, H, W]`` gradient.

    On a CUDA tensor this launches K7, which reads the cost as a residual
    (``n r = c``).  A CPU tensor takes the plain closed form.
    ``.launches`` counts K7's launches.
    """
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    cost = check_volume(cost, camera, D, "K7 cost")
    cotangent = check_volume(cotangent, camera, D, "K7 cotangent")
    if camera.device.type == "cpu":
        return projector_grad_banded(camera, projector,
                                     cost.permute(0, 2, 3, 1),
                                     cotangent.permute(0, 2, 3, 1), D, k,
                                     epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    lib = _build.kernels()
    B, H, W = camera.shape
    p = k // 2
    grad = camera.new_empty((B, H, W))
    cam_s, cam_e2, a1p = camera.new_empty((3, B, H, W)).unbind(0)
    # The projector's statistics and z2, z3 on the extended columns
    # -p .. W-1.
    proj_s, proj_e2, z2, z3 = camera.new_empty((4, B, H, W + p)).unbind(0)
    with torch.cuda.device(camera.device):
        code = lib.custereo_projector_grad(
            ptr(camera), ptr(projector), ptr(cam_s), ptr(cam_e2),
            ptr(proj_s), ptr(proj_e2), ptr(cost), ptr(cotangent), ptr(a1p),
            ptr(z2), ptr(z3), ptr(grad), B, H, W, D, k, float(epsilon),
            stream_of(camera.device))
    _build.check(code, "K7 projector VJP launch")
    projector_grad_banded_cuda.launches += 1
    return grad


projector_grad_banded_cuda.launches = 0
