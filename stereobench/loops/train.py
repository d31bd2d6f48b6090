"""Camera optimisation: ``models/optimize.py``'s train step with Adam.

Set-up makes one batch of scenes from the seed; the camera starts at the
rendered view plus Gaussian noise, the target is the scenes' disparity,
and the loss is the MSE of the soft disparity.  It builds one train state
(camera leaf and Adam) and one step function, drives them through the
first steps (``first_steps``, recorded for the check), and hands that
same state to the window, which runs the same call on the same projector
and target until ``--seconds`` have passed, with at most ``inflight``
steps queued ahead of the device.  One step of the window, drawn from
the seed among the first ``check_within``, is recorded too.  Mix
parameters: ``learning_rate``, ``start_noise``, ``first_steps``,
``inflight``, ``check_within`` and the traced stretch (``trace_from``,
``trace_steps``).

The step is the program's own (``make_train_step``); what the benchmark
adds is a matcher subclass that keeps the maps of a recorded step, the
optimizer's step hooks that open and close its span where tracing is on,
and the copies of a recorded step's state.
"""

from __future__ import annotations

import random
import sys

import torch

from stereobench import checks, harness, leastwork, tracing
from stereobench.reference import train as ref_train
from stereobench.traffic import generator


def recording_matcher(config):
    """A ``StereoMatcher`` that keeps the maps of the calls made while
    ``recording`` is set (the soft disparity, mask and confidence the
    loss was computed from)."""
    from custereomatching_tpu_torch.models.stereo import StereoMatcher

    class Recording(StereoMatcher):
        recording = False
        recorded = None

        def _keep(self, maps):
            if self.recording:
                self.recorded = tuple(x.detach().clone() for x in (
                    maps.soft_disparity, maps.mask, maps.confidence))
            return maps

        def trainable_disparity_maps(self, camera, projector):
            return self._keep(super().trainable_disparity_maps(camera,
                                                               projector))

        def disparity(self, cost_volume):
            return self._keep(super().disparity(cost_volume))

    return Recording(config)


def optimizer_span(optimizer) -> None:
    """Open ``stereobench.optimizer_step`` before each optimizer step and
    close it after."""
    open_spans = []

    def pre(opt, args, kwargs):
        s = torch.profiler.record_function(tracing.OPTIMIZER)
        s.__enter__()
        open_spans.append(s)

    def post(opt, args, kwargs):
        open_spans.pop().__exit__(None, None, None)

    optimizer.register_step_pre_hook(pre)
    optimizer.register_step_post_hook(post)


def run(r: harness.Run) -> harness.Outcome:
    from custereomatching_tpu_torch.models import optimize

    cfg, mix = r.cell.config, r.cell.traffic
    H, W, B = int(cfg["height"]), int(cfg["width"]), int(cfg["frames_per_call"])
    lr = float(mix["learning_rate"])
    harness.mark(r, "port imported")
    sc = generator.scenes(r.seed, B, H, W, cfg["scene"], r.device)
    projector, target = sc.projector, sc.disparity
    camera0 = sc.camera + generator.perturbation(
        r.seed, sc.camera.shape, float(mix["start_noise"]), r.device)
    harness.mark(r, "scenes made")
    model = recording_matcher(harness.stereo_config(cfg))
    state = optimize.init_state(camera0, optimize.adam(lr))
    if r.trace:
        optimizer_span(state.optimizer)
    step_fn = optimize.make_train_step(model)
    beta1 = state.optimizer.param_groups[0]["betas"][0]

    def moments(state):
        """Adam's moments and count of the camera; zeros where the
        optimizer holds none (it never stepped)."""
        s = state.optimizer.state.get(state.camera, {})
        zero = torch.zeros_like(state.camera.detach())
        return {"exp_avg": s.get("exp_avg", zero),
                "exp_avg_sq": s.get("exp_avg_sq", zero),
                "step": s.get("step", 0)}

    def recorded(state, fresh):
        """One step of ``step_fn``, and what it produced."""
        adam = None
        if not fresh:
            s = moments(state)
            adam = ref_train.AdamState(m=s["exp_avg"].clone(),
                                       v=s["exp_avg_sq"].clone(),
                                       t=int(s["step"]))
        before = state.camera.detach().clone()
        model.recording = True
        state, metrics = step_fn(state, projector, target)
        model.recording = False
        if fresh:
            # The first gradient as the optimizer got it: m = (1 - b1) g.
            grad = moments(state)["exp_avg"] / (1.0 - beta1)
        else:
            grad = state.camera.grad.detach().clone()
        soft, mask, conf = model.recorded
        rec = checks.StepRecord(
            camera=before, loss=metrics.loss.detach().clone(), soft=soft,
            mask=mask, confidence=conf, grad=grad,
            change=state.camera.detach().double() - before.double(),
            adam=adam)
        return state, rec

    harness.mark(r, "state built")
    first = []
    for i in range(int(mix["first_steps"])):
        state, rec = recorded(state, fresh=(i == 0))
        first.append(rec)
    harness.sync(r.device)
    setup_s = harness.now() - r.started

    check_at = random.Random(r.seed).randrange(int(mix["check_within"]))
    window = []
    stretch = tracing.Stretch(r.trace, int(mix["trace_from"]),
                              int(mix["trace_steps"]), r.device)
    least = max(int(mix["check_within"]), stretch.last)
    inflight = harness.Inflight(r.device, int(mix["inflight"]))
    steps = failed = 0
    t0 = harness.now()
    deadline = t0 + r.seconds
    while True:
        stretch.at(steps)
        try:
            with tracing.span("stereobench.train_step", r.trace):
                if steps == check_at:
                    state, rec = recorded(state, fresh=False)
                    window.append(rec)
                else:
                    state, _ = step_fn(state, projector, target)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"step {steps} failed: {e!r}", file=sys.stderr)
            break
        inflight.push()
        steps += 1
        if steps >= least and harness.now() >= deadline:
            break
    stretch.at(steps)
    harness.sync(r.device)
    window_s = harness.now() - t0
    peak = harness.memory_peak(r.device)
    print(f"train: {steps} steps in {window_s:.4f} s; loss "
          f"{float(first[0].loss):.6g} at the start", file=sys.stderr)

    del state, step_fn, model
    found = checks.judge_train(first, window, projector, target, cfg, lr,
                               r.cell.limits)
    return harness.Outcome(
        setup_s=setup_s,
        values={"step_ms": 1e3 * window_s / max(steps, 1)},
        attempted=steps + failed, failed=failed, checks=found,
        memory_peak_bytes=peak, stretch=stretch,
        work=leastwork.train_step(cfg, B), frames_per_unit=B)
