"""Plain camera optimisation: the MSE loss of the soft disparity, its
camera gradient by autograd of the plain ops in :mod:`.zncc`, and Adam.

The loss of a ``[B, H, W]`` camera is ``mean((soft * mask - target)^2)``
over every pixel of every frame; the mask carries no gradient.  It is a
sum over frames, so each frame's forward and backward run alone, which
bounds the memory to one frame's graph.

Adam is ``torch.optim.Adam``'s and optax's update, written out: with
``t`` the step count, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
g^2`` and ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from stereobench.reference import zncc

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


class Evaluation(NamedTuple):
    loss: torch.Tensor         # scalar
    soft: torch.Tensor         # [B, H, W] soft disparity, masked
    confidence: torch.Tensor   # [B, H, W]
    mask: torch.Tensor         # [B, H, W] the mask the loss used (bool)
    ref_mask: torch.Tensor     # [B, H, W] confidence > threshold (bool)
    grad: torch.Tensor         # [B, H, W] d loss / d camera


def evaluate(camera: torch.Tensor, projector: torch.Tensor,
             target: torch.Tensor, config: dict, dtype: torch.dtype,
             other_mask: Optional[torch.Tensor] = None,
             tie: float = 0.0) -> Evaluation:
    """Loss, maps and camera gradient of a ``[B, H, W]`` camera, computed
    in ``dtype``.  ``other_mask`` (bool) is the judged side's mask, taken
    where the confidence lies within ``tie`` of the threshold
    (:func:`.zncc.used_mask`)."""
    B = camera.shape[0]
    n = camera.numel()
    thr = float(config["cost_threshold"])
    outs = {key: [] for key in Evaluation._fields if key != "loss"}
    loss = torch.zeros((), dtype=torch.float64, device=camera.device)
    for b in range(B):
        cam = camera[b].detach().to(dtype).requires_grad_(True)
        proj = projector[b].to(dtype)
        h = zncc.head(zncc.volume(cam, proj, config), config)
        mask = zncc.used_mask(
            h.mask, h.confidence.detach(),
            None if other_mask is None else other_mask[b], thr, tie)
        soft = h.soft * mask.to(dtype)
        err = soft - target[b].to(dtype)
        part = torch.sum(err * err) / n
        part.backward()
        loss += part.detach().to(torch.float64)
        outs["soft"].append(soft.detach())
        outs["confidence"].append(h.confidence.detach())
        outs["mask"].append(mask)
        outs["ref_mask"].append(h.mask)
        outs["grad"].append(cam.grad)
    return Evaluation(loss=loss, **{k: torch.stack(v)
                                    for k, v in outs.items()})


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: int


def adam_zero(like: torch.Tensor, dtype: torch.dtype) -> AdamState:
    z = torch.zeros(like.shape, dtype=dtype, device=like.device)
    return AdamState(m=z, v=z.clone(), t=0)


def adam_update(state: AdamState, grad: torch.Tensor, lr: float):
    """``(change, next state)`` of one Adam step, in the state's dtype."""
    g = grad.to(state.m.dtype)
    t = state.t + 1
    m = BETA1 * state.m + (1 - BETA1) * g
    v = BETA2 * state.v + (1 - BETA2) * g * g
    bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
    change = -(lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + ADAM_EPS)
    return change, AdamState(m=m, v=v, t=t)


def adam_gain(t: int) -> float:
    """``K_t = (1 - b1) sqrt((1 - b2^t) / (1 - b2)) / (1 - b1^t)``: the
    most by which step t's update at a pixel moves, in units of the
    learning rate, when that step's gradient there is scaled by ``1 + a``,
    beyond ``a`` times the update itself (PERF.md derives it)."""
    return ((1 - BETA1) * math.sqrt((1 - BETA2 ** t) / (1 - BETA2))
            / (1 - BETA1 ** t))
