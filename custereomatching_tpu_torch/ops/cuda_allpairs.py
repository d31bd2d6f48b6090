"""Wrapper of kernel K8, the all-pairs ZNCC cost volume on the card, and
its autograd node.

The counterpart of ``custereomatching_tpu/ops/pallas_allpairs.py``
(``pallas_cost_volume_allpairs`` and ``stereo_matching_pallas_allpairs``).
The kernel is ``csrc/zncc_allpairs.cu``; its plain version is
:func:`.zncc.forward_allpairs`.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or the call raises.

``precision``: the JAX op's "highest" is exact fp32 MXU passes and
"default" lets the TPU take bf16 passes.  K8 sums in exact fp32 CUDA-core
FMAs for both (no TF32 tensor-core product); a reduced-precision variant
is later work.
"""

from __future__ import annotations

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.cuda_large_k import allpairs_volume_large
from custereomatching_tpu_torch.ops.cuda_zncc import prepare, smem_floats
from custereomatching_tpu_torch.ops.zncc import (
    EPSILON,
    camera_grad_allpairs,
    forward_allpairs,
)
from custereomatching_tpu_torch.utils.kernel_model import large_k_route

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
    (``cuda_large_k.allpairs_volume_large``).  ``.launches`` counts K8's
    launches.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    k = int(kernel_size)
    camera, projector = prepare(camera, projector, 0, k, min_kernel_size=1)
    if camera.device.type == "cpu":
        return forward_allpairs(camera, projector, k, epsilon)
    if camera.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA or (plain) CPU tensors, got "
                         f"{camera.device}")
    if large_k_route("K8", k, budget=smem_floats(camera.device)):
        return allpairs_volume_large(camera, projector, k, epsilon)
    B, H, W = camera.shape
    out = camera.new_empty((B, H, W, W))
    stats = camera.new_empty((4, B, H, W))
    with torch.cuda.device(camera.device):
        _build.launch(
            "K8", "custereo_allpairs_volume",
            ptr(camera), ptr(projector), *(ptr(s) for s in stats.unbind(0)),
            ptr(out), B, H, W, k, float(epsilon), stream_of(camera.device),
            what="K8 all-pairs volume launch")
    cost_volume_allpairs_cuda.launches += 1
    return out


cost_volume_allpairs_cuda.launches = 0


class CudaAllPairsMatching(torch.autograd.Function):
    """K8 as an autograd node, the counterpart of ``_allpairs_fwd`` /
    ``_allpairs_bwd``: the residuals are the images and the volume, the
    backward is the plain closed form :func:`.zncc.camera_grad_allpairs`
    (the JAX package leaves it to XLA too), and the projector gets no
    gradient (``None``)."""

    @staticmethod
    def forward(ctx, camera, projector, kernel_size, epsilon, precision):
        cost = cost_volume_allpairs_cuda(camera, projector, kernel_size,
                                         epsilon, precision)
        ctx.save_for_backward(camera, projector, cost)
        ctx.args = (kernel_size, epsilon)
        return cost

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        camera, projector, cost = ctx.saved_tensors
        cam_grad = camera_grad_allpairs(camera, projector, grad.contiguous(),
                                        cost, *ctx.args)
        return cam_grad, None, None, None, None
