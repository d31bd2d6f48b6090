"""Wrappers of kernels K9a and K9b: a banded volume's layout conversions
on the card.

The counterparts of ``custereomatching_tpu/ops/pallas_layout.py``
(``plane_major_to_parity`` and ``parity_to_plane_major``).  The port's
volumes are exact, so there is no padding to crop or to fill with zeros:
each direction is one transpose between plane-major ``[B, D+1, H, W]``
(what K1 and K3w write, what K2, K6 and K7 read) and parity
``[B, H, W, D+1]`` (the reference's layout).  The kernel is
``csrc/layout.cu``.  The plain versions are ``permute(...).contiguous()``,
which is also the one PyTorch call that computes the same function.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or the
call raises.  ``[D+1, H, W]`` and ``[H, W, D+1]`` volumes are taken as one
frame.
"""

from __future__ import annotations

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of


def _check(x: torch.Tensor, what: str) -> None:
    if x.ndim not in (3, 4):
        raise ValueError(f"{what}: expected a 3-d or 4-d volume, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {x.dtype}")


def plane_major_to_parity_reference(volume: torch.Tensor) -> torch.Tensor:
    """Plain version of K9a.  ``.calls`` counts its uses."""
    plane_major_to_parity_reference.calls += 1
    return volume.movedim(-3, -1).contiguous()


plane_major_to_parity_reference.calls = 0


def parity_to_plane_major_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain version of K9b.  ``.calls`` counts its uses."""
    parity_to_plane_major_reference.calls += 1
    return g.movedim(-1, -3).contiguous()


parity_to_plane_major_reference.calls = 0


def _transpose(x: torch.Tensor, out_shape, planes: int, entry: str,
               what: str, wrapper) -> torch.Tensor:
    """Launch one of the two C entries on ``x`` (contiguous) into a new
    ``out_shape`` tensor, counting the launch on ``wrapper``."""
    x = x.contiguous()
    out = x.new_empty(out_shape)
    if x.numel() == 0:
        return out
    frames = x.shape[0] if x.ndim == 4 else 1
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        code = getattr(lib, entry)(ptr(x), ptr(out), frames, planes,
                                   x.numel() // (frames * planes),
                                   stream_of(x.device))
    _build.check(code, f"{what} launch")
    wrapper.launches += 1
    return out


def plane_major_to_parity(volume: torch.Tensor) -> torch.Tensor:
    """``[B, D+1, H, W]`` (or ``[D+1, H, W]``) to a contiguous
    ``[B, H, W, D+1]`` (or ``[H, W, D+1]``).  ``.launches`` counts K9a's
    launches."""
    _check(volume, "K9a")
    if volume.device.type == "cpu":
        return plane_major_to_parity_reference(volume)
    if volume.device.type != "cuda":
        raise ValueError(f"K9a runs on CUDA or (plain) CPU tensors, got "
                         f"{volume.device}")
    shape = tuple(volume.shape)
    return _transpose(volume, shape[:-3] + shape[-2:] + shape[-3:-2],
                      shape[-3], "custereo_plane_major_to_parity",
                      "K9a plane-major to parity", plane_major_to_parity)


plane_major_to_parity.launches = 0


def parity_to_plane_major(g: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, D+1]`` (or ``[H, W, D+1]``) to a contiguous
    ``[B, D+1, H, W]`` (or ``[D+1, H, W]``).  ``.launches`` counts K9b's
    launches."""
    _check(g, "K9b")
    if g.device.type == "cpu":
        return parity_to_plane_major_reference(g)
    if g.device.type != "cuda":
        raise ValueError(f"K9b runs on CUDA or (plain) CPU tensors, got "
                         f"{g.device}")
    shape = tuple(g.shape)
    return _transpose(g, shape[:-3] + shape[-1:] + shape[-3:-1], shape[-1],
                      "custereo_parity_to_plane_major",
                      "K9b parity to plane-major", parity_to_plane_major)


parity_to_plane_major.launches = 0
