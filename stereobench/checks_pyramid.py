"""The comparisons that decide ``correct`` in a pyramid cell, and its
control.

What is judged is what the timed path produced at each sampled call: the
four maps the matcher returned and, recorded inside the same call
(``loops/pyramid.py``), the fine level's four maps and the shift the warp
gave it.  The reference (``reference/pyramid.py``, float64) recomputes
everything from the inputs the benchmark made:

  * the fine level on the program's own shift: ``conf_gap``, ``mask_gap``,
    ``soft_gap`` and ``argmax_gap`` as :func:`checks.judge_frame_maps`
    defines them, over the band of 2r + 1 planes;
  * the composition: the reference's composition of the program's own fine
    level and shift against the maps returned, folded into the same four
    numbers: the largest gap of the confidence and of the soft disparity,
    and ``OUT_OF_RANGE`` in ``mask_gap`` or ``argmax_gap`` where a mask or
    a hard disparity differs at all (a composition is integer arithmetic
    on the fine level: it has no tie to excuse);
  * ``shift_gap``: the share of pixels whose shift differs from the
    reference's own, computed from the reference's coarse level, leaving
    out the pixels where the reference's ``d_up = f d_coarse`` lies within
    ``shift_tie`` (a limits entry, px) of a rounding boundary: there a
    last-bit difference of the coarse estimate rightly moves the shift;
  * ``excused_share``: the share of pixels whose shift differs and that
    the tie left out, held to a limit of its own, so that a fault cannot
    hide in the excuse (a wrong shift differs at every pixel, and the tie's
    band of about ``2 shift_tie`` of them then counts here).

The control is the reference itself computed in bfloat16, put in the
program's place and judged the same way.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch

from stereobench import checks
from stereobench.reference import pyramid as ref

REF = checks.REF
CONTROL = checks.CONTROL
NUMBERS = ("conf_gap", "mask_gap", "soft_gap", "argmax_gap", "shift_gap",
           "excused_share")


def _maps(d: Dict[str, torch.Tensor]) -> ref.Maps:
    return ref.Maps(**{k: d[k].to(REF) for k in ref.Maps._fields})


def judge_frame(out: Dict[str, torch.Tensor], fine: Dict[str, torch.Tensor],
                shift: torch.Tensor, camera: torch.Tensor,
                projector: torch.Tensor, config: dict, tie: float
                ) -> Dict[str, float]:
    """The six numbers of one frame, and ``tie_needed`` (not compared):
    ``out`` the returned maps, ``fine`` the fine level's, ``shift`` the
    warp's, each ``[H, W]``."""
    cam, proj = camera.to(REF), projector.to(REF)
    shift = shift.to(REF)
    gaps = checks.judge_frame_maps(fine, cam, ref.warp(proj, shift),
                                   ref.fine_config(config))
    want = ref.compose(_maps(fine), shift)
    got = _maps(out)
    gaps["conf_gap"] = checks.worse(gaps["conf_gap"], checks._max(
        (got.confidence - want.confidence).abs()))
    gaps["soft_gap"] = checks.worse(gaps["soft_gap"], checks._max(
        (got.soft_disparity - want.soft_disparity).abs()))
    if bool((got.mask != want.mask).any()):
        gaps["mask_gap"] = checks.OUT_OF_RANGE
    if bool((got.disparity != want.disparity).any()):
        gaps["argmax_gap"] = checks.OUT_OF_RANGE
    own = ref.coarse(cam, proj, config)
    # How far d_up lies from a rounding boundary, a half-integer.
    dist = ((own.d_up - torch.floor(own.d_up)) - 0.5).abs()
    near = dist <= tie
    differs = shift != own.shift
    n = float(differs.numel())
    gaps["shift_gap"] = float((differs & ~near).sum()) / n
    gaps["excused_share"] = float((differs & near).sum()) / n
    # Not compared: the tie this frame needed, the largest distance of a
    # differing pixel (0.5 where a shift is wrong everywhere).
    gaps["tie_needed"] = checks._max(dist[differs])
    return gaps


def judge(samples: List[dict], config: dict, limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` over samples of ``{"maps": {name:
    [B, H, W]}, "fine": {name: [B, H, W]}, "shift": [B, H, W], "camera":
    [B, H, W], "projector": [B, H, W]}``, frame by frame: the largest of
    each number (NaN where nothing was judged)."""
    worst: Dict[str, float] = {}
    for s in samples:
        for b in range(s["camera"].shape[0]):
            found = judge_frame({k: v[b] for k, v in s["maps"].items()},
                                {k: v[b] for k, v in s["fine"].items()},
                                s["shift"][b], s["camera"][b],
                                s["projector"][b], config,
                                float(limits["shift_tie"]))
            for name, value in found.items():
                worst[name] = checks.worse(worst.get(name, 0.0), value)
    if "tie_needed" in worst:
        print(f"pyramid check: the shift's tie needed "
              f"{worst['tie_needed']!r} px, stated {limits['shift_tie']!r}",
              file=sys.stderr)
    return {name: {"value": worst.get(name, math.nan),
                   "limit": limits[name]} for name in NUMBERS}


def control_sample(camera: torch.Tensor, projector: torch.Tensor,
                   config: dict) -> dict:
    """The control: the reference's pyramid of a ``[B, H, W]`` batch
    computed in bfloat16, as a sample in the program's format."""
    frames = [ref.frame(c.to(CONTROL), p.to(CONTROL), config)
              for c, p in zip(camera, projector)]

    def stack(part):
        return {k: torch.stack([getattr(getattr(f, part), k)
                                for f in frames]).to(torch.float32)
                for k in ref.Maps._fields}

    return {"maps": stack("maps"), "fine": stack("fine"),
            "shift": torch.stack([f.coarse.shift for f in frames]
                                 ).to(torch.float32),
            "camera": camera, "projector": projector}
