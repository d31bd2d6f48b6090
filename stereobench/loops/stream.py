"""A depth stream: ``StereoMatcher.disparity_maps`` on batches of frames
already on the card, dispatched ahead.

A closed loop with a bounded queue: the host waits for the call
``inflight`` calls back before it issues the next, so the device never
waits on the host while the host never runs unboundedly ahead.  Each
call's mask is summed on the device (a consumer's reduction), so no call
is dead.  Mix parameters: ``distinct_batches`` (resident batches the
calls cycle through), ``inflight``, ``check_calls`` sampled from the
seed among the first ``check_within`` calls, and the traced stretch
(``trace_from``, ``trace_calls``).
"""

from __future__ import annotations

import random
import sys

import torch

from stereobench import checks, harness, leastwork, tracing
from stereobench.traffic import generator


def run(r: harness.Run) -> harness.Outcome:
    from custereomatching_tpu_torch.models.stereo import StereoMatcher

    cfg, mix = r.cell.config, r.cell.traffic
    H, W, B = int(cfg["height"]), int(cfg["width"]), int(cfg["frames_per_call"])
    nb = int(mix["distinct_batches"])
    model = StereoMatcher(harness.stereo_config(cfg))
    harness.mark(r, "model built")
    sc = generator.scenes(r.seed, nb * B, H, W, cfg["scene"], r.device)
    batches = [(sc.camera[i * B:(i + 1) * B], sc.projector[i * B:(i + 1) * B])
               for i in range(nb)]
    harness.mark(r, "scenes made")
    consumed = torch.zeros((), device=r.device)
    with torch.no_grad():
        model.disparity_maps(*batches[0])
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
            try:
                with tracing.span("stereobench.disparity_maps", r.trace):
                    maps = model.disparity_maps(cam, proj)
                consumed.add_(maps.mask.sum())
            except (RuntimeError, ValueError) as e:
                failed += 1
                if failed == 1:
                    print(f"call {calls} failed: {e!r}", file=sys.stderr)
                maps = None
            if calls in sampled and maps is not None:
                kept.append({"maps": maps._asdict(), "camera": cam,
                             "projector": proj})
            inflight.push()
            calls += 1
            if calls >= least and harness.now() >= deadline:
                break
        stretch.at(calls)
        harness.sync(r.device)
    window_s = harness.now() - t0
    peak = harness.memory_peak(r.device)
    print(f"stream: {calls} calls of {B} frames in {window_s:.4f} s; mask "
          f"coverage {float(consumed) / (calls * B * H * W):.4f}",
          file=sys.stderr)

    del model
    gaps = checks.judge_maps(kept, cfg)
    return harness.Outcome(
        setup_s=setup_s,
        values={"frames_per_s": calls * B / window_s},
        attempted=calls, failed=failed,
        checks=checks.map_checks(gaps, r.cell.limits),
        memory_peak_bytes=peak, stretch=stretch,
        work=leastwork.maps(cfg, B), frames_per_unit=B)
