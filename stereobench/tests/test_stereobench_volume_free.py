"""The pieces of the cells ``middlebury2014_train.volume_free`` and
``kitti2015.volume``: the row-band reference against the whole-frame one,
the judge that reads it, the backward's least work, the new readers on
small synthetic traces, and both loops on the CPU at tiny sizes."""

from collections import Counter

import pytest
import torch

from stereobench import (checks, checks_volume_free, harness, leastwork,
                         leastwork_train, tracing)
from stereobench.reference import train as ref_train
from stereobench.reference import train_bands
from stereobench.tests import tiny
from stereobench.traffic import generator

MAIN, STREAM = 1, 7
PEAKS = leastwork.PEAKS["NVIDIA H100 80GB HBM3"]
FREE = "middlebury2014_train.volume_free"
VOLUME = "kitti2015.volume"


def _case(k, D, B=3, H=23, W=37, seed=2 ** 31 + 41):
    cfg = dict(kernel_size=k, num_disparities=D, epsilon=1e-8,
               softargmax_beta=50.0, cost_threshold=0.6)
    sc = generator.scenes(seed, B, H, W, dict(tiny.SCENE, d_min=1.0,
                                              d_max=D - 1.0), tiny.CPU)
    cam = sc.camera + generator.perturbation(seed, sc.camera.shape, 0.05,
                                             tiny.CPU)
    return cfg, cam, sc.projector, sc.disparity


# Band heights: one row, fewer rows than the halo, a few bands, the frame.
@pytest.mark.parametrize("rows", [1, 5, 8, 64])
@pytest.mark.parametrize("k,D", [(3, 6), (15, 8)])
def test_the_bands_are_the_whole_frame_evaluation(k, D, rows):
    cfg, cam, proj, target = _case(k, D)
    other = torch.rand(cam.shape, generator=torch.Generator().manual_seed(3)
                       ) < 0.5
    want = ref_train.evaluate(cam, proj, target, cfg, torch.float64, other,
                              0.05)
    got = train_bands.evaluate(cam, proj, target, cfg, torch.float64, [2, 0],
                               other, 0.05, rows=rows)
    # float64 over sums ordered otherwise: a few ulp of each value.
    assert float(got.loss) == pytest.approx(float(want.loss), rel=1e-12)
    for name in ("soft", "confidence"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-12)
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.ref_mask, want.ref_mask)
    torch.testing.assert_close(got.grad, want.grad[[2, 0]], rtol=1e-10,
                               atol=1e-14)


def test_the_bands_take_the_dtype_they_are_given():
    cfg, cam, proj, target = _case(5, 6)
    want = ref_train.evaluate(cam, proj, target, cfg, torch.float64)
    got = train_bands.evaluate(cam, proj, target, cfg, torch.bfloat16, [1],
                               rows=4)
    assert got.soft.dtype == got.grad.dtype == torch.bfloat16
    assert got.grad.shape == (1,) + tuple(cam.shape[1:])
    # bfloat16 is near the reference but not at it.
    assert 0 < abs(float(got.loss) - float(want.loss)) < 0.05 * float(
        want.loss)


def test_the_bands_refuse_all_pairs():
    cfg, cam, proj, target = _case(3, 6)
    with pytest.raises(ValueError, match="banded"):
        train_bands.evaluate(cam, proj, target,
                             dict(cfg, num_disparities=None),
                             torch.float64, [0])


def test_the_frames_are_drawn_from_the_seed():
    a = checks_volume_free.drawn(2 ** 33 + 1, 15)
    assert a == checks_volume_free.drawn(2 ** 33 + 1, 15)
    assert a != checks_volume_free.drawn(2 ** 33 + 2, 15)
    for frames in a:
        assert len(frames) == 3 and frames == sorted(set(frames))
        assert all(0 <= f < 15 for f in frames)
    assert checks_volume_free.drawn(5, 2) == ([0, 1], [0, 1])


def _records(cfg, cam, proj, target, lr, steps):
    """The plain twin's own steps, recorded as the program's are."""
    recs, adam = [], None
    state = ref_train.adam_zero(cam, torch.float32)
    for i in range(steps):
        ev = ref_train.evaluate(cam, proj, target, cfg, torch.float32)
        change, after = ref_train.adam_update(state, ev.grad, lr)
        recs.append(checks.StepRecord(
            camera=cam, loss=ev.loss, soft=ev.soft,
            mask=ev.mask.to(torch.float32), confidence=ev.confidence,
            grad=ev.grad, change=change.double(),
            adam=None if i == 0 else adam))
        adam = after
        state, cam = after, cam + change
    return recs


def test_with_every_frame_drawn_the_judge_is_judge_train():
    cfg, cam, proj, target = _case(5, 8, B=3)
    limits = harness.resolve(tiny.manifest(), FREE).limits
    recs = _records(cfg, cam, proj, target, 1e-2, 4)
    want = checks.judge_train(recs[:3], recs[3:], proj, target, cfg, 1e-2,
                              limits)
    got = checks_volume_free.judge(recs[:3], recs[3:], proj, target, cfg,
                                   1e-2, limits, seed=7)
    assert set(got) == set(want)
    for name in want:
        assert got[name]["value"] == pytest.approx(want[name]["value"],
                                                   rel=1e-6, abs=1e-12)
        assert got[name]["limit"] == pytest.approx(want[name]["limit"],
                                                   rel=1e-9)


def test_the_control_is_judged_not_correct():
    cfg, cam, proj, target = _case(5, 8, B=4)
    limits = harness.resolve(tiny.manifest(), FREE).limits
    recs = checks_volume_free.control(cam, proj, target, cfg, 1e-2, 11)
    found = checks_volume_free.judge(recs, [], proj, target, cfg, 1e-2,
                                     limits, 11)
    assert not checks.verdict(found), found


def test_the_backward_counts_every_entry_once():
    cfg = harness.resolve(tiny.manifest(), FREE).config
    assert (cfg["height"], cfg["width"], cfg["num_disparities"],
            cfg["frames_per_call"]) == (1988, 2880, 289, 15)
    bwd = leastwork_train.backward(cfg, 15)
    entries = 15 * 1988 * 2880 * 290
    assert bwd.flops == (8 + 2 * 15 + 9) * entries
    assert bwd.bytes == 4 * 4 * 15 * 1988 * 2880
    step = leastwork_train.train_step(cfg, 15)
    assert tuple(step) == tuple(leastwork.train_step(cfg, 15))
    assert step.backward == bwd


def host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": MAIN}


def launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "pid": 1, "tid": MAIN,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"kernel_{corr}", "ts": ts,
            "dur": dur, "pid": 0, "tid": STREAM,
            "args": {"correlation": corr}}


def free_step(at, corr, volume_free=True):
    """A step at ``at`` (us): the forward's span (K3m and its statistics
    pass, 30 and 10 us), then the backward's (K5, 100 us) and Adam (10)."""
    forward = "custereo.model.volume_free" if volume_free else "other"
    return [
        host("custereo.train.loss", at, 100),
        host(forward, at + 5, 80),
        launch(corr, at + 10), kernel(corr, at + 20, 10),
        launch(corr + 1, at + 30), kernel(corr + 1, at + 40, 30),
        host(tracing.BACKWARD + ": K5", at + 120, 60),
        launch(corr + 2, at + 130), kernel(corr + 2, at + 140, 100),
        launch(corr + 3, at + 250), kernel(corr + 3, at + 260, 10),
    ]


def summary(events, units, work=None, peaks=None):
    return tracing.Summary([host(tracing.STRETCH, 0, 1000)] + events,
                           units, units, work, peaks)


def read(name, t):
    return harness.reader(name)(t)


def test_the_forward_is_what_the_volume_free_span_launched():
    t = summary(free_step(10, 1) + free_step(400, 11), units=2)
    assert read("forward_ms.volume_free", t) == pytest.approx(1e-3 * 40)
    assert read("backward_ms.volume", t) == pytest.approx(1e-3 * 100)


def test_the_backward_roofline_reads_the_backward_work():
    work = leastwork_train.StepWork(flops=67e12 * 150e-6, bytes=0.0)
    work.backward = leastwork.Work(flops=67e12 * 25e-6, bytes=0.0)
    t = summary(free_step(10, 1) + free_step(400, 11), 2, work, PEAKS)
    # 25 us of least work over the backward's 100 us a step.
    assert read("roofline_bwd.volume_free", t) == pytest.approx(25.0)
    # The step's 150 us over 150 us of kernels a step; 300 us of 1000 busy.
    assert read("roofline.volume_free", t) == pytest.approx(100.0)
    assert read("roofline.volume", t) == pytest.approx(100.0)
    assert read("device_idle.volume_free", t) == pytest.approx(70.0)
    assert read("device_idle.volume", t) == pytest.approx(70.0)


def test_a_program_without_the_span_or_the_work_reads_nothing():
    events = free_step(10, 1, volume_free=False)
    t = summary(events, 1, leastwork.Work(1.0, 1.0), PEAKS)
    assert read("forward_ms.volume_free", t) is None
    assert read("roofline_bwd.volume_free", t) is None


def test_the_volume_free_loop_takes_k3m_and_k5_where_the_volume_drops(
        monkeypatch):
    """On the CPU with the ``cuda`` backend forced and a card too small
    for the volume, each step of the tiny cell runs the volume-free twins
    (K3m's and K5's) through ``trainable_disparity_maps``."""
    from custereomatching_tpu_torch.config import StereoConfig
    from custereomatching_tpu_torch.models import stereo
    from custereomatching_tpu_torch.utils.profiling import COUNTS

    monkeypatch.setattr(stereo, "card_memory", lambda index: 1)
    monkeypatch.setattr(StereoConfig, "resolved_backend",
                        lambda self, device: "cuda")
    before = COUNTS.copy()
    result = tiny.execute(FREE, trace=True)
    ran = COUNTS - before
    steps = result["attempted"]
    assert result["correct"] is True, result["checks"]
    assert ran["train.volume_free"] == steps + 3
    assert ran["plain.fused_pipeline_bwd_reference"] == steps + 3
    assert "plain.stereo_pipeline_trainable_reference" not in ran


def test_the_volume_loop_takes_the_volume_path():
    from custereomatching_tpu_torch.utils.profiling import COUNTS

    before = COUNTS.copy()
    result = tiny.execute(VOLUME, trace=True)
    ran = COUNTS - before
    steps = result["attempted"] + 3
    assert result["correct"] is True, result["checks"]
    assert ran == Counter({"plain.forward_banded": steps,
                           "plain.camera_grad_banded": steps})
    # The backward's spans are traced; the CPU launches no device work.
    assert result["metrics"]["backward_ms.volume"]["value"] == 0.0
