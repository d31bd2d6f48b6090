"""Exit-coded parity check of the port at the reference's verify workload.

The counterpart of ``examples/verify.py``: the reference's own protocol
(an all-ones cotangent) plus random cotangents, with numeric tolerances and
a non-zero exit code on failure.  On a CUDA card each kernel is held
against its plain PyTorch version on the same inputs: K1 (banded volume),
K2 (camera VJP), K7 (projector VJP) and K8 (all-pairs volume), and the
camera gradient through K8's autograd node against the plain node's.  The
closed-form VJPs are also held against torch autograd of the moments-form
forward.  On the CPU the kernel wrappers take their plain versions, so
there only the closed forms are checked against autograd, at a small size.

    python -m custereomatching_tpu_torch.examples.verify   # 330x422, D=200, k=15 on a card
    python -m custereomatching_tpu_torch.examples.verify --device cpu
        # the plain versions at 24x48, D=8, k=5

It runs on the card unless ``--device cpu`` asks for the CPU (without a
card and without it, it raises); on the CPU the default workload is that
small one.  The data is a
synthetic speckle pair (the reference's input images are not in its
repository); ``--skip-allpairs`` leaves out the ``[H, W, W]`` volume.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch.config import entry_device
from custereomatching_tpu_torch.data import make_stereo_pair
from custereomatching_tpu_torch.ops import stereo_matching
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.cuda_zncc import cost_volume_banded_cuda
from custereomatching_tpu_torch.ops.zncc import (
    camera_grad_allpairs,
    camera_grad_banded,
    forward_allpairs,
    forward_banded,
    projector_grad_banded,
    stereo_matching_torch,
    stereo_matching_with_proj_grad,
)

# The reference's constants (H, W, D, k) and a small CPU workload.
REFERENCE = (330, 422, 200, 15)
SMALL = (24, 48, 8, 5)
# Forward: the JAX suite's tolerance.  Gradients: divided by the largest
# |reference| first, then the JAX verify script's tolerance.
FWD_TOL = (1e-4, 1e-5)
GRAD_TOL = (1e-4, 5e-6)


def check(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float, scaled: bool = False) -> bool:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if scaled:
        scale = float(want.abs().max())
        got, want = got / scale, want / scale
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()
              and torch.isfinite(got).all())
    print(f"  {'PASS' if ok else 'FAIL'}  {name}: max_abs_err="
          f"{float(err.max()):.3e} (rtol={rtol:g}, atol={atol:g}"
          f"{', scaled by max |want|' if scaled else ''})")
    return ok


def grads(fn, camera: torch.Tensor, projector: torch.Tensor,
          cotangent: torch.Tensor, wrt=(0,)) -> List[torch.Tensor]:
    """Gradients of ``sum(fn(camera, projector) * cotangent)``."""
    inputs = [x.detach().clone().requires_grad_(i in wrt)
              for i, x in enumerate((camera, projector))]
    loss = torch.sum(fn(*inputs) * cotangent)
    return list(torch.autograd.grad(loss, [inputs[i] for i in wrt]))


def verify_banded(cam, proj, D: int, k: int, rng) -> bool:
    ok = True
    print("banded forward:")
    cost = forward_banded(cam, proj, D, k)
    ok &= check("K1 vs plain", cost_volume_banded_cuda(cam, proj, D, k),
                cost, *FWD_TOL)

    def op(c, p):
        return stereo_matching(c, p, D, k, grad_projector=True)

    print("banded backward (all-ones cotangent, reference protocol):")
    ones = torch.ones_like(cost)
    (g_cam,) = grads(op, cam, proj, ones)
    ok &= check("K2 vs plain", g_cam,
                camera_grad_banded(cam, proj, ones, D, k), *GRAD_TOL,
                scaled=True)

    print("banded backward (random cotangent):")
    g = torch.from_numpy(rng.standard_normal(
        tuple(cost.shape)).astype(np.float32)).to(cam.device)
    g_cam, g_proj = grads(op, cam, proj, g, wrt=(0, 1))
    want_cam = camera_grad_banded(cam, proj, g, D, k)
    want_proj = projector_grad_banded(cam, proj, cost, g, D, k)
    ok &= check("K2 vs plain", g_cam, want_cam, *GRAD_TOL, scaled=True)
    ok &= check("K7 vs plain", g_proj, want_proj, *GRAD_TOL, scaled=True)
    auto_cam, auto_proj = grads(
        lambda c, p: stereo_matching_with_proj_grad(c, p, D, k), cam, proj,
        g, wrt=(0, 1))
    ok &= check("plain camera VJP vs autograd", want_cam, auto_cam,
                *GRAD_TOL, scaled=True)
    ok &= check("plain projector VJP vs autograd", want_proj, auto_proj,
                *GRAD_TOL, scaled=True)
    return ok


def verify_allpairs(cam, proj, k: int, rng) -> bool:
    ok = True
    print("all-pairs forward + backward (reference layout [H, W, W]):")
    cost = forward_allpairs(cam, proj, k)
    ok &= check("K8 vs plain", cost_volume_allpairs_cuda(cam, proj, k),
                cost, *FWD_TOL)
    ones = torch.ones_like(cost)
    (g_node,) = grads(lambda c, p: stereo_matching(c, p, None, k), cam,
                      proj, ones)
    (g_plain,) = grads(lambda c, p: stereo_matching_torch(c, p, None, k),
                       cam, proj, ones)
    ok &= check("camera grad through K8's node vs the plain node", g_node,
                g_plain, *GRAD_TOL, scaled=True)
    g = torch.from_numpy(rng.standard_normal(
        tuple(cost.shape)).astype(np.float32)).to(cam.device)
    (auto,) = grads(lambda c, p: stereo_matching_with_proj_grad(
        c, p, None, k), cam, proj, g)
    ok &= check("plain all-pairs camera VJP vs autograd",
                camera_grad_allpairs(cam, proj, g, cost, k), auto,
                *GRAD_TOL, scaled=True)
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--disparities", "-D", type=int, default=None)
    ap.add_argument("--kernel-size", "-k", type=int, default=None)
    ap.add_argument("--skip-allpairs", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    default = REFERENCE if device.type == "cuda" else SMALL
    H, W, D, k = (v if v is not None else d for v, d in zip(
        (args.height, args.width, args.disparities, args.kernel_size),
        default))
    cam_np, proj_np, _ = make_stereo_pair(H, W, d_min=2.0,
                                          d_max=min(D, 12.0), noise=0.01,
                                          seed=0)
    cam = torch.from_numpy(cam_np)[None].to(device)
    proj = torch.from_numpy(proj_np)[None].to(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"workload: H={H} W={W} D={D} k={k} device={name!r}")
    rng = np.random.default_rng(7)

    ok = verify_banded(cam, proj, D, k, rng)
    if not args.skip_allpairs:
        ok &= verify_allpairs(cam, proj, k, rng)
    print("VERIFY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
