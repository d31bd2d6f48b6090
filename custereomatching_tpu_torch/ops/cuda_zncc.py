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

import ctypes
import functools
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
from custereomatching_tpu_torch.ops.cuda_large_k import (
    banded_volume_large,
    camera_grad_large,
    projector_grad_large,
)
from custereomatching_tpu_torch.utils.kernel_model import (
    K_TILE_H,
    TILE_ROWS,
    cost_slab_planes,
    large_k_route,
)

# The banded kernels reject k < 3 (the JAX Pallas banded kernels do too):
# k = 1 is the degenerate no-window case, which the plain op keeps.  K8
# takes k = 1, as JAX's _allpairs_kernel does (cuda_allpairs.py).
MIN_KERNEL_SIZE = 3
# The most k K7 takes, as JAX's _proj_bwd_kernel (k // 2 * 2 <= 128,
# pallas_zncc_bwd.py:839-841).
K7_MAX_KERNEL_SIZE = 129


def prepare(camera: torch.Tensor, projector: torch.Tensor,
            num_disparities: int, kernel_size: int,
            min_kernel_size: int = MIN_KERNEL_SIZE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate a ``[B, H, W]`` fp32 pair for the kernels (odd k >=
    ``min_kernel_size``); returns it contiguous."""
    check_pair(camera, projector, kernel_size, min_kernel_size)
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


@functools.lru_cache(maxsize=None)
def _optin_floats(index: int) -> int:
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin // 4


def smem_floats(device: torch.device) -> int:
    """The shared memory a block may opt into on ``device``, in floats: the
    attribute the launchers read (``cudaDevAttrMaxSharedMemoryPerBlockOptin``),
    the budget at which the wrappers ask ``kernel_model`` whether a
    kernel's own blocks fit (``large_k_route``, ``cost_slab_planes``)."""
    return _optin_floats(torch.device(device).index or 0)


# The kernels whose rounds take a tile, and the tuner's name of each
# (``ops.tuning.candidate_blocks``).
TILE_KINDS = {"K1": "volume", "K3": "pipeline", "K3w": "pipeline",
              "K3m": "pipeline", "K4": "trainable_bwd"}


def own_blocks(kernel: str, camera: torch.Tensor, num_disparities: int,
               kernel_size: int, tile_rows: int = K_TILE_H,
               planes: int = 0) -> bool:
    """Whether ``kernel`` (K1, the K3 family or K4) runs its own blocks on
    ``camera``'s card at the tile ``(tile_rows, planes)``: the default
    tile (16 rows, ``planes`` 0: ``fused_round``'s) where they fit, else
    False and the wrapper takes the large-k route.  Another tile runs
    where ``kernel_model.large_k_route`` says its blocks fit; elsewhere it
    raises ``ValueError`` naming the tiles that do
    (``ops.tuning.candidate_blocks``), before any launch: a tile is never
    changed for another."""
    D, k = int(num_disparities), int(kernel_size)
    budget = smem_floats(camera.device)
    if tile_rows == K_TILE_H and planes == 0:
        return not large_k_route(kernel, k, D, budget)
    if (tile_rows in TILE_ROWS and isinstance(planes, int) and planes >= 0
            and not large_k_route(kernel, k, D, budget, tile_rows, planes)):
        return True
    # Imported here: ops.tuning imports the wrappers.
    from custereomatching_tpu_torch.ops.tuning import candidate_blocks

    B, H, W = camera.shape
    kind = TILE_KINDS[kernel]
    raise ValueError(
        f"{kernel}: no block of tile ({tile_rows}, {planes}) runs at H={H}, "
        f"W={W}, D={D}, k={k} on this card; candidate_blocks({kind!r}) "
        f"gives {candidate_blocks(kind, H, W, D, k, budget)}")


def check_projector_kernel_size(k: int) -> None:
    """K7's gate: k <= ``K7_MAX_KERNEL_SIZE``, with the ``ValueError`` of
    JAX's ``_proj_bwd_kernel`` beyond."""
    if k > K7_MAX_KERNEL_SIZE:
        raise ValueError(f"kernel_size {k} exceeds the lane-aligned ext "
                         f"margin (k//2*2 must be <= 128)")


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
                            epsilon: float = EPSILON,
                            tile_rows: int = K_TILE_H,
                            planes: int = 0) -> torch.Tensor:
    """Banded ZNCC volume of ``[B, H, W]`` pairs: ``[B, H, W, D+1]``.

    On a CUDA tensor this launches K1, which writes the volume
    plane-major ``[B, D+1, H, W]``; the result is a permuted view of it.
    ``tile_rows`` (8, 16 or 32) and ``planes`` (a round, 0 for the
    kernel's own choice) set its rounds kernel's tile, the counterpart of
    ``(hb, dt)`` of JAX's ``pallas_cost_volume_banded_hdw``; the values
    are the same at every tile, and a tile that does not fit raises
    ``ValueError`` (:func:`own_blocks`).  Where K1's block does not fit
    at the default tile (k >= 129 on an H100) the large-k route writes
    the volume (``cuda_large_k.banded_volume_large``).  A CPU tensor takes
    the plain version, which has no tile.
    """
    D, k = int(num_disparities), int(kernel_size)
    camera, projector = prepare(camera, projector, D, k)
    if camera.device.type == "cpu":
        return forward_banded(camera, projector, D, k, epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    if not own_blocks("K1", camera, D, k, tile_rows, planes):
        return banded_volume_large(camera, projector, D, k,
                                   epsilon).permute(0, 2, 3, 1)
    B, H, W = camera.shape
    out = camera.new_empty((B, D + 1, H, W))
    scratch = stats_scratch(camera, D)
    with torch.cuda.device(camera.device):
        _build.launch(
            "K1", "custereo_banded_volume",
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch),
            ptr(out), B, H, W, D, k, float(epsilon),
            stream_of(camera.device), int(tile_rows), int(planes),
            what="K1 banded volume launch")
    return out.permute(0, 2, 3, 1)


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


def cost_slab(camera: torch.Tensor, kernel: str, num_disparities: int,
              kernel_size: int) -> Optional[torch.Tensor]:
    """The slab of K1's costs that K5's or K6's chunked route fills
    (``[B, planes, H, W]``, the planes ``kernel_model.cost_slab_planes``
    gives), or None where the kernel recomputes the cost in its own
    block."""
    planes = cost_slab_planes(kernel, int(kernel_size), int(num_disparities),
                              smem_floats(camera.device))
    if not planes:
        return None
    B, H, W = camera.shape
    return camera.new_empty((B, planes, H, W))


def ptr_or_null(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else ptr(t)


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
    the plain closed form, which recomputes the cost.  Where the kernel's
    blocks do not fit (k >= 129 on an H100) the large-k route runs
    (``cuda_large_k.camera_grad_large``).
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
    if large_k_route(what, k, D, smem_floats(camera.device)):
        return camera_grad_large(camera, projector, volume[0] if volume
                                 else None, cotangent, D, k, epsilon)
    entry = ("custereo_camera_grad_recompute" if cost is None
             else "custereo_camera_grad")
    B, H, W = camera.shape
    grad = camera.new_empty((B, H, W))
    scratch = grad_scratch(camera, D)
    # K6's chunked route fills a slab of K1's costs (after the stream).
    slab = cost_slab(camera, "K6", D, k) if cost is None else None
    with torch.cuda.device(camera.device):
        _build.launch(
            what, entry,
            ptr(camera), ptr(projector), *(ptr(s) for s in scratch[:4]),
            *(ptr(v) for v in volume), ptr(cotangent),
            *(ptr(s) for s in scratch[4:]), ptr(grad), B, H, W, D, k,
            float(epsilon), stream_of(camera.device),
            *((ptr_or_null(slab),) if cost is None else ()),
            what=f"{what} camera VJP launch")
    return grad


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
    (``n r = c``), or, where its blocks do not fit (k = 129 on an H100),
    the large-k route (``cuda_large_k.projector_grad_large``); k >= 131
    raises ``ValueError`` before any launch, as JAX's ``_proj_bwd_kernel``
    does.  A CPU tensor takes the plain closed form.
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
    check_projector_kernel_size(k)
    if large_k_route("K7", k, D, smem_floats(camera.device)):
        return projector_grad_large(camera, projector, cost, cotangent, D, k,
                                    epsilon)
    B, H, W = camera.shape
    p = k // 2
    grad = camera.new_empty((B, H, W))
    cam_s, cam_e2, a1p = camera.new_empty((3, B, H, W)).unbind(0)
    # The projector's statistics and z2, z3 on the extended columns
    # -p .. W-1.
    proj_s, proj_e2, z2, z3 = camera.new_empty((4, B, H, W + p)).unbind(0)
    with torch.cuda.device(camera.device):
        _build.launch(
            "K7", "custereo_projector_grad",
            ptr(camera), ptr(projector), ptr(cam_s), ptr(cam_e2),
            ptr(proj_s), ptr(proj_e2), ptr(cost), ptr(cotangent), ptr(a1p),
            ptr(z2), ptr(z3), ptr(grad), B, H, W, D, k, float(epsilon),
            stream_of(camera.device), what="K7 projector VJP launch")
    return grad
