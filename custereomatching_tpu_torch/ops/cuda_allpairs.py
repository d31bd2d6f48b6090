"""Wrappers of kernel K8, the all-pairs ZNCC cost volume on the card, and
K8b, its camera VJP, and their autograd node.

The counterpart of ``custereomatching_tpu/ops/pallas_allpairs.py``
(``pallas_cost_volume_allpairs`` and ``stereo_matching_pallas_allpairs``).
The kernels are ``csrc/zncc_allpairs.cu`` and ``csrc/zncc_allpairs_bwd.cu``
(K8b replaces no TPU kernel: the JAX package leaves the VJP to XLA); their
plain versions are :func:`.zncc.forward_allpairs` and
:func:`.zncc.camera_grad_allpairs`.  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or the call raises.

``precision``: the JAX op's "highest" is exact fp32 MXU passes and
"default" lets the TPU take bf16 passes.  K8 sums in exact fp32 CUDA-core
FMAs for both (no TF32 tensor-core product); a reduced-precision variant
is later work.
"""

from __future__ import annotations

import ctypes

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops import cuda_large_k as lk
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.cuda_zncc import prepare, smem_floats
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    camera_grad_allpairs,
    forward_allpairs,
)
from custereomatching_tpu_torch.utils.kernel_model import (
    allpairs_grad_taps,
    combine_block_floats,
    large_k_route,
)
from custereomatching_tpu_torch.utils.profiling import span

PRECISIONS = ("highest", "default")


def cost_volume_allpairs_cuda(camera: torch.Tensor, projector: torch.Tensor,
                              kernel_size: int = 15,
                              epsilon: float = EPSILON,
                              precision: str = "highest") -> torch.Tensor:
    """All-pairs ZNCC volume of ``[B, H, W]`` pairs: ``[B, H, W, W]``, the
    last axis the absolute projector column.

    On a CUDA tensor this launches K8 (exact fp32 for either
    ``precision``) at every odd k >= 1, as JAX's ``_allpairs_kernel``
    takes them (k = 1 included: one staged row, a one-tap sweep, E2 = 0,
    so every cost is eps / sqrt(eps)); where its strip does not fit
    (k >= 145 on an H100) the large-k route writes the volume
    (``cuda_large_k.allpairs_volume_large``).
    """
    return allpairs_volume_and_stats(camera, projector, kernel_size,
                                     epsilon, precision)[0]


def allpairs_volume_and_stats(camera: torch.Tensor, projector: torch.Tensor,
                              kernel_size: int = 15,
                              epsilon: float = EPSILON,
                              precision: str = "highest"):
    """:func:`cost_volume_allpairs_cuda`'s volume and, on a CUDA tensor,
    the window statistics it was made from (``cam_s``, ``cam_e2``,
    ``proj_s``, ``proj_e2``, each ``[B, H, W]``), which K8b reads; on a CPU
    tensor no statistics (``()``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    k = int(kernel_size)
    camera, projector = prepare(camera, projector, 0, k, min_kernel_size=1)
    if camera.device.type == "cpu":
        return forward_allpairs(camera, projector, k, epsilon), ()
    if camera.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    if large_k_route("K8", k, budget=smem_floats(camera.device)):
        return lk.allpairs_volume_large(camera, projector, k, epsilon)
    B, H, W = camera.shape
    out = camera.new_empty((B, H, W, W))
    stats = camera.new_empty((4, B, H, W))
    with torch.cuda.device(camera.device):
        _build.launch(
            "K8", "custereo_allpairs_volume",
            ptr(camera), ptr(projector), *(ptr(s) for s in stats.unbind(0)),
            ptr(out), B, H, W, k, float(epsilon), stream_of(camera.device),
            what="K8 all-pairs volume launch")
    return out, stats.unbind(0)


def camera_grad_allpairs_cuda(camera: torch.Tensor, projector: torch.Tensor,
                              grad: torch.Tensor, cost: torch.Tensor,
                              stats, kernel_size: int = 15,
                              epsilon: float = EPSILON) -> torch.Tensor:
    """Camera VJP of the all-pairs volume: ``[B, H, W]`` pairs, the
    cotangent ``grad`` and the forward volume ``cost`` (both ``[B, H, W,
    W]``) to a ``[B, H, W]`` gradient, as
    :func:`.zncc.camera_grad_allpairs` computes it.

    On a CUDA tensor this launches K8b (``csrc/zncc_allpairs_bwd.cu``),
    one pass over the cotangent and the cost, at every odd k >= 1 and
    every B; ``stats`` are the window statistics the volume was made from
    (``cam_s``, ``cam_e2``, ``proj_s``, ``proj_e2``, each ``[B, H, W]``:
    K8's, or the large-k route's).  K8b ends with the banded VJPs' combine
    kernel where its tiles fit (k <= 193 on an H100), else with the
    large-k route's combine.  Every tensor must be fp32, contiguous and on
    the camera's card, or the call raises.  A CPU tensor takes the plain
    version, which recomputes the statistics (``stats`` unused).
    """
    k = int(kernel_size)
    camera, projector = prepare(camera, projector, 0, k, min_kernel_size=1)
    if camera.device.type == "cpu":
        return camera_grad_allpairs(camera, projector, grad, cost, k,
                                    epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"K8b runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    B, H, W = camera.shape
    stats = tuple(stats)
    if len(stats) != 4:
        raise ValueError(f"K8b: expected 4 statistics maps, got "
                         f"{len(stats)}")
    for what, t, shape in ((("cotangent", grad, (B, H, W, W)),
                            ("cost", cost, (B, H, W, W)))
                           + tuple((f"statistics map {i}", s, (B, H, W))
                                   for i, s in enumerate(stats))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != camera.device or not t.is_contiguous():
            raise ValueError(
                f"K8b {what}: expected a contiguous float32 {shape} on "
                f"{camera.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}{'' if t.is_contiguous() else ', strided'}")
    j_lo, taps = allpairs_grad_taps(W, k)
    combine = combine_block_floats(k) <= smem_floats(camera.device)
    e = camera.new_empty((B, H, taps, W))
    a1, bm, grmu, out = camera.new_empty((4, B, H, W)).unbind(0)
    with span("custereo.vjp.allpairs"), torch.cuda.device(camera.device):
        _build.launch(
            "K8b", "custereo_allpairs_grad",
            ptr(grad), ptr(cost), ptr(camera), ptr(projector),
            *(ptr(s) for s in stats), ptr(e), ptr(a1), ptr(bm), ptr(grmu),
            ptr(out) if combine else ctypes.c_void_p(None), B, H, W, k,
            j_lo, taps, float(epsilon), stream_of(camera.device),
            what="K8b all-pairs camera VJP launch")
        if not combine:
            boxes = lk.box2d_stack(
                lk.grad_stack(bm, grmu, stats[0], k).flatten(0, 1), k)
            out = lk.grad_combine(a1, boxes.view(3, B, H, W), camera)
    return out


class CudaAllPairsMatching(torch.autograd.Function):
    """K8 as an autograd node, the counterpart of ``_allpairs_fwd`` /
    ``_allpairs_bwd``: the residuals are the images, the volume and, on
    the card, the window statistics K8 made it from; the backward is K8b
    on the card (:func:`camera_grad_allpairs_cuda`) and the plain closed
    form :func:`.zncc.camera_grad_allpairs` on the CPU, and the projector
    gets no gradient (``None``)."""

    @staticmethod
    def forward(ctx, camera, projector, kernel_size, epsilon, precision):
        cost, stats = allpairs_volume_and_stats(camera, projector,
                                                kernel_size, epsilon,
                                                precision)
        ctx.save_for_backward(camera, projector, cost, *stats)
        ctx.args = (kernel_size, epsilon)
        return cost

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        camera, projector, cost, *stats = ctx.saved_tensors
        cam_grad = camera_grad_allpairs_cuda(
            camera, projector, grad.contiguous(), cost, stats, *ctx.args)
        return cam_grad, None, None, None, None
