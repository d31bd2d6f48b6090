"""Plain camera optimisation in row bands: :mod:`.train`'s loss, maps and
camera gradient at frame sizes whose whole-frame graph no card holds.

:func:`.train.evaluate` builds one frame's autograd graph over its whole
``[H, W, D+1]`` volume; at 2880x1988 over 290 planes that is 13 GB a
tensor in float64, and the graph holds several.  Here each frame is cut
into bands of ``rows`` rows.  A band's maps and loss need the images
``k // 2`` rows beyond it (every window that touches the band), and its
camera gradient the costs ``k // 2`` rows beyond it, so the images
``2 (k // 2)`` rows beyond: a band is computed on that halo, with zero
rows where it passes the frame's edge, and its window sums are exact
("valid") along the rows.  The loss is a sum over pixels, so a band's
gradient on its own rows is the whole frame's there.

The arithmetic is :mod:`.zncc`'s (its image moments, its cost formula,
its head and :func:`.zncc.used_mask`) on two changes of layout that do
not change a value: the columns are taken right to left, so that a
band's plane ``d`` at pixel ``w`` reads the projector's window statistics
through a strided view (:meth:`torch.Tensor.unfold`) and no volume-sized
gather is made, and the volume's window sums are pooling passes
(``avg_pool3d`` with a divisor of 1: the k taps of each sum added in
order, rows first, as :func:`.zncc.box`), which read each entry once
where :func:`.zncc.window_sum` makes k passes.  Pooling a bfloat16 volume
adds in float32 and rounds once, on the CPU as the card's kernel does.

Maps and loss are taken at every frame; the gradient at the frames the
caller names, the others' forward running without a graph.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from stereobench.reference import zncc
from stereobench.reference.train import Evaluation

# Rows a band computes at once: its float64 volume is ~1 GB at 2880
# columns over 290 planes with the halo of k = 15.
BAND_ROWS = 128


def _pool(x: torch.Tensor, kernel, padding) -> torch.Tensor:
    """Window sums of an ``[R, W, L]`` volume over the pooled axes,
    accumulated in at least float32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    out = F.avg_pool3d(x.to(acc)[None], kernel, stride=1, padding=padding,
                       divisor_override=1)[0]
    return out.to(x.dtype)


def band_costs(cam: torch.Tensor, proj: torch.Tensor, config: dict
               ) -> torch.Tensor:
    """``[R - 2p, W, D+1]`` costs of the rows ``p .. R - p`` of ``[R, W]``
    image rows (zero rows where they pass the frame's edge), ``p = k //
    2``, the columns right to left: column ``W - 1 - w`` holds pixel
    ``w``."""
    k, eps = int(config["kernel_size"]), float(config["epsilon"])
    D = int(config["num_disparities"])
    p = k // 2
    R, W = cam.shape
    k2 = float(k * k)
    cam_r = cam.flip(1)
    # Reversed, the projector widened by D zero columns on its left:
    # ext_r[w' + d] is the projector at pixel w - d (w' = W - 1 - w).
    ext_r = torch.cat([proj.flip(1), proj.new_zeros((R, D))], dim=1)
    sx, ex2 = zncc.moments(cam_r, k)
    sy, ey2 = zncc.moments(ext_r, k)
    rows = slice(p, R - p)
    prod = cam_r[:, :, None] * ext_r.unfold(1, D + 1, 1)
    sxy = _pool(_pool(prod, (k, 1, 1), 0), (1, k, 1), (0, p, 0))
    sy_d = sy[rows].unfold(1, D + 1, 1)
    ey2_d = ey2[rows].unfold(1, D + 1, 1)
    exy = sxy - sx[rows, :, None] * sy_d / k2
    return (exy + eps) * torch.rsqrt(ex2[rows, :, None] * ey2_d + eps)


def evaluate(camera: torch.Tensor, projector: torch.Tensor,
             target: torch.Tensor, config: dict, dtype: torch.dtype,
             grad_frames: Sequence[int],
             other_mask: Optional[torch.Tensor] = None, tie: float = 0.0,
             rows: int = BAND_ROWS) -> Evaluation:
    """:func:`.train.evaluate` of a ``[B, H, W]`` camera, computed in
    ``dtype`` a band of ``rows`` rows at a time: the loss and the maps of
    every frame, the gradient ``[len(grad_frames), H, W]`` of the frames
    ``grad_frames`` (in that order).  The loss is the mean over every
    pixel of every frame."""
    if config["num_disparities"] is None:
        raise ValueError("the bands evaluate banded configurations only")
    B, H, W = camera.shape
    n = camera.numel()
    thr = float(config["cost_threshold"])
    p = int(config["kernel_size"]) // 2
    dev = camera.device
    soft = torch.empty((B, H, W), dtype=dtype, device=dev)
    conf = torch.empty_like(soft)
    mask = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    ref_mask = torch.empty_like(mask)
    grads = torch.zeros((len(grad_frames), H, W), dtype=dtype, device=dev)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    with zncc.exact_matmul():
        for b in range(B):
            grad = b in grad_frames
            # Output rows beyond the band: none for the maps, p for the
            # costs its gradient reads.  Image rows: p more.
            reach = p if grad else 0
            for a in range(0, H, rows):
                e = min(H, a + rows)
                lo, hi = a - reach - p, e + reach + p
                i0, i1 = max(0, lo), min(H, hi)
                cam = camera[b, i0:i1].detach().to(dtype, copy=True)
                cam.requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    pad = (0, 0, i0 - lo, hi - i1)
                    costs = band_costs(F.pad(cam, pad),
                                       F.pad(projector[b, i0:i1].to(dtype),
                                             pad), config)
                    # Cost rows [lo + p, hi - p); those inside the frame.
                    o0, o1 = max(0, lo + p), min(H, hi - p)
                    h = zncc.head(costs[o0 - lo - p:o1 - lo - p], config)
                    out = slice(o0, o1)
                    other = (None if other_mask is None
                             else other_mask[b, out].flip(1))
                    used = zncc.used_mask(h.mask, h.confidence.detach(),
                                          other, thr, tie)
                    s = h.soft * used.to(dtype)
                    err = s - target[b, out].to(dtype).flip(1)
                    core = slice(a - o0, e - o0)
                    if grad:
                        (torch.sum(err * err) / n).backward()
                        grads[grad_frames.index(b), a:e] = \
                            cam.grad[a - i0:e - i0]
                    c = err[core].detach()
                    loss += (torch.sum(c * c) / n).to(torch.float64)
                soft[b, a:e] = s[core].detach().flip(1)
                conf[b, a:e] = h.confidence[core].detach().flip(1)
                mask[b, a:e] = used[core].flip(1)
                ref_mask[b, a:e] = h.mask[core].flip(1)
    return Evaluation(loss=loss, soft=soft, confidence=conf, mask=mask,
                      ref_mask=ref_mask, grad=grads)
