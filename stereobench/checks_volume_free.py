"""The comparison that decides ``correct`` in a train cell whose frames are
too large for :func:`checks.judge_train`'s reference: the same numbers
under the same limits, the reference computed in row bands
(:mod:`reference.train_bands`).

What changes is only where each number is read:

  * ``loss_gap``, ``soft_gap``, ``mask_gap`` and ``conf_gap`` over every
    frame of each compared step;
  * ``grad_gap``, ``grad_gap_steps``, ``change_gap``,
    ``change_gap_window`` and ``direction_gap`` over ``grad_frames``
    frames drawn from the seed (the reference's gradient is the costly
    part): one draw for the first steps, whose Adam the reference follows
    from a zero state on those frames, another for the sampled window
    step.  Adam acts on each pixel alone, so a frame's change depends on
    that frame's gradient and moments only.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

from stereobench import checks
from stereobench.checks import REF, StepRecord
from stereobench.reference import train as ref_train
from stereobench.reference import train_bands

GRAD_FRAMES = 3


def drawn(seed: int, frames: int, count: int = GRAD_FRAMES):
    """``(first, window)``: the frames whose gradient is compared at the
    first steps and at the window's sampled step, ``count`` each (all
    where fewer), drawn from the seed."""
    gen = random.Random(seed * 2 + 1)
    count = min(count, frames)
    return (sorted(gen.sample(range(frames), count)),
            sorted(gen.sample(range(frames), count)))


def judge(first: List[StepRecord], window: List[StepRecord],
          projector: torch.Tensor, target: torch.Tensor, config: dict,
          lr: float, limits: Dict[str, float], seed: int
          ) -> Dict[str, Dict[str, float]]:
    """:func:`checks.judge_train`'s ``{name: {"value", "limit"}}``, the
    gradients and changes on the frames :func:`drawn` gives."""
    worst: Dict[str, float] = {}
    tie = limits["mask_gap"]
    sel_first, sel_window = drawn(seed, first[0].camera.shape[0])

    def evaluate(rec, frames):
        ev = train_bands.evaluate(rec.camera, projector, target, config,
                                  REF, frames, checks._judged_mask(rec), tie)
        gaps = checks._step_gaps(rec._replace(grad=rec.grad[frames]), ev,
                                 config)
        return ev, gaps

    def keep(gaps, grad_name):
        gaps = dict(gaps)
        gaps[grad_name] = gaps.pop("grad_gap")
        for name, value in gaps.items():
            worst[name] = checks.worse(worst.get(name, 0.0), value)

    state = ref_train.adam_zero(first[0].camera[sel_first], REF)
    change_r = torch.zeros_like(state.m)
    change_abs = torch.zeros_like(change_r)
    change_p = torch.zeros_like(change_r)
    gain = 0.0
    moved = None
    for i, rec in enumerate(first):
        grad_name = "grad_gap" if i == 0 else "grad_gap_steps"
        a = limits[grad_name]
        ev, gaps = evaluate(rec, sel_first)
        keep(gaps, grad_name)
        step, state = ref_train.adam_update(state, ev.grad, lr)
        judged = rec.change[sel_first]
        worst["direction_gap"] = checks.worse(
            worst.get("direction_gap", 0.0),
            checks._direction_gap(judged, step, state.m))
        change_r += step
        change_abs += a * step.abs()
        change_p += judged
        gain += a * ref_train.adam_gain(state.t)
        nz = ev.grad != 0
        moved = nz if moved is None else (moved | nz)
    n = float(moved.sum())
    checks_out: Dict[str, Dict[str, float]] = {}
    change = {"value": checks._change_gap(change_p, change_r),
              "limit": (lr * gain * math.sqrt(n) + checks._norm(change_abs))
              / checks._norm(change_r)}

    window_change = None
    for rec in window:
        ev, gaps = evaluate(rec, sel_window)
        keep(gaps, "grad_gap_steps")
        adam = ref_train.AdamState(m=rec.adam.m[sel_window].to(REF),
                                   v=rec.adam.v[sel_window].to(REF),
                                   t=rec.adam.t)
        step, after = ref_train.adam_update(adam, ev.grad, lr)
        judged = rec.change[sel_window]
        worst["direction_gap"] = checks.worse(
            worst["direction_gap"], checks._direction_gap(judged, step,
                                                          after.m))
        n = float((ev.grad != 0).sum())
        entry = {"value": checks._change_gap(judged, step),
                 "limit": limits["grad_gap_steps"]
                 * (lr * ref_train.adam_gain(after.t) * math.sqrt(n)
                    + checks._norm(step)) / checks._norm(step)}
        if (window_change is None
                or entry["value"] / entry["limit"]
                > window_change["value"] / window_change["limit"]):
            window_change = entry

    for name in ("loss_gap", "soft_gap", "mask_gap", "conf_gap",
                 "grad_gap", "grad_gap_steps", "direction_gap"):
        checks_out[name] = {"value": worst[name], "limit": limits[name]}
    checks_out["change_gap"] = change
    if window_change is not None:
        checks_out["change_gap_window"] = window_change
    return checks_out


def control(camera0: torch.Tensor, projector: torch.Tensor,
            target: torch.Tensor, config: dict, lr: float, seed: int,
            steps: int = 3) -> List[StepRecord]:
    """The control: the reference's own steps from the same start,
    computed in bfloat16 in bands, recorded as the program's are.  It
    takes gradients where the judge reads them (the first steps' frames
    of :func:`drawn`) and leaves the other frames where they start."""
    frames, _ = drawn(seed, camera0.shape[0])
    cam = camera0.to(checks.CONTROL)
    state = ref_train.adam_zero(cam[frames], checks.CONTROL)
    records = []
    for _ in range(steps):
        ev = train_bands.evaluate(cam, projector, target, config,
                                  checks.CONTROL, frames)
        change, state = ref_train.adam_update(state, ev.grad, lr)
        after = cam.clone()
        after[frames] += change
        grad = torch.zeros_like(cam)
        grad[frames] = ev.grad
        records.append(StepRecord(
            camera=cam.to(torch.float32), loss=ev.loss,
            soft=ev.soft.to(torch.float32),
            mask=ev.mask.to(torch.float32),
            confidence=ev.confidence.to(torch.float32),
            grad=grad.to(torch.float32),
            change=after.to(REF) - cam.to(REF), adam=None))
        cam = after
    return records
