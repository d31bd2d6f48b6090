"""Wrapper of kernel K1, the banded ZNCC cost volume on the card.

The counterpart of ``custereomatching_tpu/ops/pallas_zncc.py``.  The
kernel is ``csrc/zncc_banded.cu``; its plain version is
:func:`.zncc.forward_banded`.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    check_pair,
    forward_banded,
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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
