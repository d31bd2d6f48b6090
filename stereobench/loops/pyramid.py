"""A depth stream through the coarse-to-fine matcher:
``PyramidStereoMatcher`` on frames already on the card, dispatched ahead.

The closed loop of ``loops/stream.py`` (a bounded queue of ``inflight``
calls, each call's mask summed on the device, ``check_calls`` sampled
from the seed among the first ``check_within``, the traced stretch
``trace_from`` / ``trace_calls``), with the configuration's ``downsample``
and ``residual``.  The matcher is the port's own class; what the
benchmark adds is a subclass that, while a sampled call runs, keeps the
fine level's maps and the shift that the call's warp gave it (as
``loops/train.py`` keeps the maps a step's loss was computed from), so
that the check can hold each level to the reference on the program's own
shift.
"""

from __future__ import annotations

import random
import sys

import torch

from stereobench import checks_pyramid, harness, leastwork_pyramid, tracing
from stereobench.traffic import generator


def recording_matcher(config, downsample: int, residual: int):
    """A ``PyramidStereoMatcher`` that keeps the fine level's maps and the
    shift of the calls made while ``state["recording"]`` is set, and that
    state."""
    from custereomatching_tpu_torch.models.pyramid import PyramidStereoMatcher

    class Recording(PyramidStereoMatcher):
        def compose(self, fine, shift):
            if state["recording"]:
                state["fine"] = {k: v.clone()
                                 for k, v in fine._asdict().items()}
                state["shift"] = shift.clone()
            return super().compose(fine, shift)

    state = {"recording": False}
    return Recording(config, downsample=downsample, residual=residual), state


def run(r: harness.Run) -> harness.Outcome:
    cfg, mix = r.cell.config, r.cell.traffic
    H, W = int(cfg["height"]), int(cfg["width"])
    B = int(cfg["frames_per_call"])
    nb = int(mix["distinct_batches"])
    model, state = recording_matcher(harness.stereo_config(cfg),
                                     int(cfg["downsample"]),
                                     int(cfg["residual"]))
    harness.mark(r, "model built")
    sc = generator.scenes(r.seed, nb * B, H, W, cfg["scene"], r.device)
    batches = [(sc.camera[i * B:(i + 1) * B], sc.projector[i * B:(i + 1) * B])
               for i in range(nb)]
    harness.mark(r, "scenes made")
    consumed = torch.zeros((), device=r.device)
    with torch.no_grad():
        model(*batches[0])
    harness.sync(r.device)
    setup_s = harness.now() - r.started

    sampled = set(random.Random(r.seed).sample(
        range(int(mix["check_within"])), int(mix["check_calls"])))
    kept = []
    stretch = tracing.Stretch(r.trace, int(mix["trace_from"]),
                              int(mix["trace_calls"]), r.device)
    least = max(int(mix["check_within"]), stretch.last)
    inflight = harness.Inflight(r.device, int(mix["inflight"]))
    calls = failed = 0
    t0 = harness.now()
    deadline = t0 + r.seconds
    with torch.no_grad():
        while True:
            stretch.at(calls)
            cam, proj = batches[calls % nb]
            state["recording"] = calls in sampled
            try:
                with tracing.span("stereobench.coarse_to_fine", r.trace):
                    maps = model(cam, proj)
                consumed.add_(maps.mask.sum())
            except (RuntimeError, ValueError) as e:
                failed += 1
                if failed == 1:
                    print(f"call {calls} failed: {e!r}", file=sys.stderr)
                maps = None
            if state["recording"] and maps is not None:
                kept.append({"maps": maps._asdict(), "fine": state["fine"],
                             "shift": state["shift"], "camera": cam,
                             "projector": proj})
            state["recording"] = False
            inflight.push()
            calls += 1
            if calls >= least and harness.now() >= deadline:
                break
        stretch.at(calls)
        harness.sync(r.device)
    window_s = harness.now() - t0
    peak = harness.memory_peak(r.device)
    print(f"pyramid: {calls} calls of {B} frames in {window_s:.4f} s; mask "
          f"coverage {float(consumed) / (calls * B * H * W):.4f}",
          file=sys.stderr)

    del model
    return harness.Outcome(
        setup_s=setup_s,
        values={"frames_per_s": calls * B / window_s},
        attempted=calls, failed=failed,
        checks=checks_pyramid.judge(kept, cfg, r.cell.limits),
        memory_peak_bytes=peak, stretch=stretch,
        work=leastwork_pyramid.maps(cfg, B), frames_per_unit=B)
