"""The comparisons that decide ``correct``, and the control.

What is judged is what the timed path produced; the reference
(``reference/``, float64) recomputes everything from the inputs the
benchmark made, and reads the judged outputs only to judge them.  The
same functions judge the control: the reference itself computed in
bfloat16, put in the program's place.

Map cells (``stream``), over the sampled calls:

  * ``conf_gap``: the largest gap of a pixel's confidence;
  * ``mask_gap``: where the judged mask differs from the reference's, how
    far the reference's confidence lies from the threshold (0 where no
    pixel differs): a flip is right only at a tie;
  * ``soft_gap``: the largest gap of the soft disparity, in pixels, where
    both masks agree;
  * ``argmax_gap``: where both masks are set, how far the reference's
    cost at the judged hard disparity lies below its largest cost (0 at
    every pixel whose disparity is the reference's, small at a tie; 2,
    the widest a cost can span, where a disparity is out of range or a
    masked pixel's disparity is not 0).

Train cells, at each compared step from the program's own camera at that
step: ``loss_gap`` (relative), ``soft_gap``, ``mask_gap``, ``conf_gap``,
the gap between the norms of the two gradients over the reference's norm
(``grad_gap`` at the first step, whose gradient is read back from Adam's
first moment, as the optimizer got it; ``grad_gap_steps`` at the later
steps, where a few pixels at near-ties of the soft-argmax can hold most
of the gap, PERF.md) and the gaps of the norms of the camera's change: ``change_gap`` over the first three steps, the reference
following Adam from a zero state, and ``change_gap_window`` over the
sampled step of the window, the reference taking Adam from the program's
moments there.  The reference's loss takes the judged mask where its own
confidence lies within ``mask_gap``'s limit of the threshold.  The two
change gaps are held to limits derived from the gradient's limit by
Adam's arithmetic (PERF.md), worked out in each run from the reference's
own update.  A gap of norms is blind to the change's direction, so
``direction_gap`` holds it, at each of those steps: the share of the
reference's squared first moment on the pixels that the judged change
does not move the reference's way (an ascent reads 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from stereobench.reference import train as ref_train
from stereobench.reference import zncc

REF = torch.float64
CONTROL = torch.bfloat16
# The widest span of a ZNCC cost, [-1, 1]: the gap given to a hard
# disparity that no plane of the volume holds.
OUT_OF_RANGE = 2.0


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def worse(a: float, b: float) -> float:
    """The larger of two gaps, NaN if either is NaN."""
    return b if (b != b or b > a) else a


def judge_frame_maps(maps: Dict[str, torch.Tensor], camera: torch.Tensor,
                     projector: torch.Tensor, config: dict
                     ) -> Dict[str, float]:
    """The four gaps of one frame's ``[H, W]`` maps."""
    vol = zncc.volume(camera.to(REF), projector.to(REF), config)
    h = zncc.head(vol, config)
    thr = float(config["cost_threshold"])
    mask = maps["mask"].to(REF) > 0.5
    conf = maps["confidence"].to(REF)
    same = mask == h.mask
    both = mask & h.mask
    soft_ref = h.soft * h.mask.to(REF)
    gaps = {
        "conf_gap": _max((conf - h.confidence).abs()),
        "mask_gap": _max((h.confidence - thr).abs()[~same]),
        "soft_gap": _max((maps["soft_disparity"].to(REF)
                          - soft_ref).abs()[same]),
    }
    index = zncc.index_of_disparity(maps["disparity"].to(REF), config)
    inside = (index >= 0) & (index < vol.shape[-1])
    picked = torch.gather(vol, -1, index.clamp(0, vol.shape[-1] - 1)[..., None]
                          )[..., 0]
    gap = torch.where(inside, h.confidence - picked,
                      torch.full_like(picked, OUT_OF_RANGE))
    unmasked_nonzero = (~mask) & (maps["disparity"] != 0)
    gaps["argmax_gap"] = worse(_max(gap[both]),
                               OUT_OF_RANGE if bool(unmasked_nonzero.any())
                               else 0.0)
    return gaps


def judge_maps(samples: List[dict], config: dict) -> Dict[str, float]:
    """The largest of each gap over samples of ``{"maps": {name: [B, H,
    W]}, "camera": [B, H, W], "projector": [B, H, W]}``, frame by
    frame."""
    worst: Dict[str, float] = {}
    for s in samples:
        for b in range(s["camera"].shape[0]):
            frame = {k: v[b] for k, v in s["maps"].items()}
            for name, value in judge_frame_maps(
                    frame, s["camera"][b], s["projector"][b],
                    config).items():
                worst[name] = worse(worst.get(name, 0.0), value)
    return worst


def control_maps(camera: torch.Tensor, projector: torch.Tensor,
                 config: dict) -> Dict[str, torch.Tensor]:
    """The control: the reference's maps of a ``[B, H, W]`` batch
    computed in bfloat16, in the program's format."""
    out = {k: [] for k in ("disparity", "soft_disparity", "mask",
                           "confidence")}
    for b in range(camera.shape[0]):
        vol = zncc.volume(camera[b].to(CONTROL), projector[b].to(CONTROL),
                          config)
        h = zncc.head(vol, config)
        m = h.mask.to(torch.float32)
        out["disparity"].append(
            zncc.disparity_of_index(h.index, config).to(torch.float32) * m)
        out["soft_disparity"].append(h.soft.to(torch.float32) * m)
        out["mask"].append(m)
        out["confidence"].append(h.confidence.to(torch.float32))
    return {k: torch.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Train cells
# ---------------------------------------------------------------------------

class StepRecord(NamedTuple):
    """What one step of the judged side produced, from its own camera."""
    camera: torch.Tensor       # [B, H, W] the camera the step started from
    loss: torch.Tensor         # scalar
    soft: torch.Tensor         # [B, H, W] masked soft disparity
    mask: torch.Tensor         # [B, H, W]
    confidence: torch.Tensor   # [B, H, W]
    grad: torch.Tensor         # [B, H, W] the gradient Adam got
    change: torch.Tensor       # [B, H, W] camera after minus before (float64)
    # The judged side's Adam moments and count before the step (None: a
    # fresh optimizer).
    adam: Optional[ref_train.AdamState]


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(REF)))


def _shaped(rec: StepRecord) -> bool:
    """Whether the judged maps cover every frame of the camera."""
    return all(x.shape == rec.camera.shape
               for x in (rec.soft, rec.mask, rec.confidence))


def _step_gaps(rec: StepRecord, ev: ref_train.Evaluation, config: dict
               ) -> Dict[str, float]:
    thr = float(config["cost_threshold"])
    loss_r = float(ev.loss)
    g_r = _norm(ev.grad)
    gaps = {"loss_gap": abs(float(rec.loss) - loss_r) / abs(loss_r),
            "soft_gap": math.nan, "mask_gap": math.nan, "conf_gap": math.nan,
            "grad_gap": abs(_norm(rec.grad) - g_r) / g_r}
    if _shaped(rec):
        mask = rec.mask.to(REF) > 0.5
        same = mask == ev.ref_mask
        gaps["soft_gap"] = _max((rec.soft.to(REF) - ev.soft).abs()[same])
        gaps["mask_gap"] = _max((ev.confidence - thr).abs()[~same])
        gaps["conf_gap"] = _max((rec.confidence.to(REF)
                                 - ev.confidence).abs())
    return gaps


def _judged_mask(rec: StepRecord) -> Optional[torch.Tensor]:
    return rec.mask > 0.5 if _shaped(rec) else None


def _change_gap(judged: torch.Tensor, ref: torch.Tensor) -> float:
    r = _norm(ref)
    return abs(_norm(judged) - r) / r


def _direction_gap(judged: torch.Tensor, ref: torch.Tensor,
                   m: torch.Tensor) -> float:
    """The share of ``m``'s squared norm (the reference's first moment,
    whose sign is its update's, opposite) on the pixels where the judged
    change's sign is not the reference change's.  A pixel moves the wrong
    way only where the two first moments differ by more than the
    reference's own, so a pixel at rounding weighs what its moment
    weighs."""
    w = m.to(REF) ** 2
    wrong = torch.sign(judged.to(REF)) != torch.sign(ref.to(REF))
    return float(w[wrong].sum()) / float(w.sum())


def judge_train(first: List[StepRecord], window: List[StepRecord],
                projector: torch.Tensor, target: torch.Tensor,
                config: dict, lr: float, limits: Dict[str, float]
                ) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` for the first steps (from a fresh
    optimizer) and the sampled window steps.  The change limits follow
    from the gradient's limits: a step whose gradient is off by a
    relative ``a`` at every pixel moves a pixel's update by at most
    ``a (lr K_t + |u|)`` (``reference.train.adam_gain``), so the norm of
    the change is off by at most ``a (lr K_t sqrt(N) + ||u||)``, N the
    pixels the reference gradient moves; over several steps the bounds
    add, each step's ``a`` its gradient's limit."""
    worst: Dict[str, float] = {}

    def keep(gaps, grad_name):
        gaps = dict(gaps)
        gaps[grad_name] = gaps.pop("grad_gap")
        for name, value in gaps.items():
            worst[name] = worse(worst.get(name, 0.0), value)

    tie = limits["mask_gap"]
    checks: Dict[str, Dict[str, float]] = {}

    state = ref_train.adam_zero(first[0].camera, REF)
    change_r = torch.zeros_like(first[0].camera, dtype=REF)
    change_abs = torch.zeros_like(change_r)
    change_p = torch.zeros_like(change_r)
    gain = 0.0
    moved = None
    for i, rec in enumerate(first):
        grad_name = "grad_gap" if i == 0 else "grad_gap_steps"
        a = limits[grad_name]
        ev = ref_train.evaluate(rec.camera, projector, target, config, REF,
                                _judged_mask(rec), tie)
        keep(_step_gaps(rec, ev, config), grad_name)
        step, state = ref_train.adam_update(state, ev.grad, lr)
        worst["direction_gap"] = worse(
            worst.get("direction_gap", 0.0),
            _direction_gap(rec.change, step, state.m))
        change_r += step
        change_abs += a * step.abs()
        change_p += rec.change
        gain += a * ref_train.adam_gain(state.t)
        nz = ev.grad != 0
        moved = nz if moved is None else (moved | nz)
    n = float(moved.sum())
    checks_change = {
        "value": _change_gap(change_p, change_r),
        "limit": (lr * gain * math.sqrt(n) + _norm(change_abs))
        / _norm(change_r)}

    window_change: Optional[Dict[str, float]] = None
    for rec in window:
        ev = ref_train.evaluate(rec.camera, projector, target, config, REF,
                                _judged_mask(rec), tie)
        keep(_step_gaps(rec, ev, config), "grad_gap_steps")
        adam = ref_train.AdamState(m=rec.adam.m.to(REF),
                                   v=rec.adam.v.to(REF), t=rec.adam.t)
        step, after = ref_train.adam_update(adam, ev.grad, lr)
        worst["direction_gap"] = worse(
            worst["direction_gap"], _direction_gap(rec.change, step, after.m))
        n = float((ev.grad != 0).sum())
        entry = {"value": _change_gap(rec.change, step),
                 "limit": limits["grad_gap_steps"]
                 * (lr * ref_train.adam_gain(after.t) * math.sqrt(n)
                    + _norm(step)) / _norm(step)}
        if (window_change is None
                or entry["value"] / entry["limit"]
                > window_change["value"] / window_change["limit"]):
            window_change = entry

    for name in ("loss_gap", "soft_gap", "mask_gap", "conf_gap",
                 "grad_gap", "grad_gap_steps", "direction_gap"):
        checks[name] = {"value": worst[name], "limit": limits[name]}
    checks["change_gap"] = checks_change
    if window_change is not None:
        checks["change_gap_window"] = window_change
    return checks


def control_train(camera0: torch.Tensor, projector: torch.Tensor,
                  target: torch.Tensor, config: dict, lr: float,
                  steps: int = 3) -> List[StepRecord]:
    """The control of a train cell: the reference's own steps from the
    same start, computed in bfloat16, recorded as the program's are."""
    cam = camera0.to(CONTROL)
    state = ref_train.adam_zero(cam, CONTROL)
    records = []
    for _ in range(steps):
        ev = ref_train.evaluate(cam, projector, target, config, CONTROL)
        change, state = ref_train.adam_update(state, ev.grad, lr)
        after = cam + change
        records.append(StepRecord(
            camera=cam.to(torch.float32), loss=ev.loss,
            soft=ev.soft.to(torch.float32),
            mask=ev.mask.to(torch.float32),
            confidence=ev.confidence.to(torch.float32),
            grad=ev.grad.to(torch.float32),
            change=after.to(REF) - cam.to(REF), adam=None))
        cam = after
    return records


def verdict(checks: Dict[str, Dict[str, float]]) -> bool:
    """Correct where every number lies within its limit (a NaN never
    does)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def map_checks(gaps: Dict[str, float], limits: Dict[str, float]
               ) -> Dict[str, Dict[str, float]]:
    return {name: {"value": gaps.get(name, math.nan), "limit": limits[name]}
            for name in ("conf_gap", "mask_gap", "soft_gap", "argmax_gap")}
