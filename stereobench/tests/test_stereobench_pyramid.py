"""The pyramid cell's own pieces: its per-layer readers on small synthetic
traces, its least work at both levels' shapes, and its checks against
the faults and the control of ``tools/calibrate_pyramid.py``, on the CPU
at tiny sizes."""

import pytest
import torch

from stereobench import (checks, checks_pyramid, harness, leastwork,
                         leastwork_pyramid, tracing)
from stereobench.tests import tiny
from stereobench.tools import calibrate_pyramid

MAIN, STREAM = 1, 7
CELL = "middlebury2014.pyramid"
NEW = ("levels_ms.pyramid", "glue_ms.pyramid", "host_ms.pyramid")
PEAKS = leastwork.PEAKS["NVIDIA H100 80GB HBM3"]


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


def summary(events, units, work=None, peaks=None):
    return tracing.Summary([host(tracing.STRETCH, 0, 1000)] + events,
                           units, units, work, peaks)


def read(name, t):
    return harness.reader(name)(t)


def pyramid_call(at, corr):
    """One call at ``at`` (us) through the port's spans: pool, the coarse
    K3, warp, the fine K3, compose, each launching one kernel of 10, 40,
    20, 100 and 30 us."""
    return [
        host("stereobench.coarse_to_fine", at, 300),
        host("custereo.model.pyramid", at + 5, 290),
        host("custereo.pyramid.pool", at + 10, 20), launch(corr, at + 15),
        kernel(corr, at + 20, 10),
        host("custereo.model.disparity_maps", at + 40, 40),
        host("custereo.kernel.K3", at + 45, 20), launch(corr + 1, at + 50),
        kernel(corr + 1, at + 60, 40),
        host("custereo.pyramid.warp", at + 100, 40),
        launch(corr + 2, at + 110),
        kernel(corr + 2, at + 120, 20),
        host("custereo.model.disparity_maps", at + 150, 40),
        host("custereo.kernel.K3", at + 155, 20), launch(corr + 3, at + 160),
        kernel(corr + 3, at + 170, 100),
        host("custereo.pyramid.compose", at + 200, 60),
        launch(corr + 4, at + 210), kernel(corr + 4, at + 280, 30),
    ]


def calls(work=None, peaks=None):
    return summary(pyramid_call(10, 1) + pyramid_call(400, 11), units=2,
                   work=work, peaks=peaks)


def test_the_levels_are_what_the_two_k3_calls_launched():
    assert read("levels_ms.pyramid", calls()) == pytest.approx(
        1e-3 * 2 * 140 / 2)


def test_the_glue_is_what_pool_warp_and_compose_launched():
    assert read("glue_ms.pyramid", calls()) == pytest.approx(
        1e-3 * 2 * 60 / 2)


def test_the_host_time_is_the_pyramid_span():
    assert read("host_ms.pyramid", calls()) == pytest.approx(1e-3 * 290)


def test_the_roofline_and_idle_read_the_device_trace():
    work = leastwork.Work(flops=67e12 * 50e-6, bytes=0.0)   # 50 us a call
    t = calls(work, PEAKS)
    # 400 us of kernels over 1000 us; 100 us of least work over 400.
    assert read("roofline.pyramid", t) == pytest.approx(25.0)
    assert read("device_idle.pyramid", t) == pytest.approx(60.0)


def test_a_level_outside_the_pyramid_is_not_a_level():
    """A ``StereoMatcher.disparity_maps`` call beside the pyramid's (the
    stream's) launches no level of it."""
    events = pyramid_call(10, 1) + [
        host("custereo.model.disparity_maps", 500, 40), launch(21, 510),
        kernel(21, 520, 300)]
    assert read("levels_ms.pyramid", summary(events, units=1)) == \
        pytest.approx(1e-3 * 140)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_pyramid_spans_reads_nothing(name):
    """The parent's trace: the levels' own spans, no pyramid span."""
    events = [e for e in pyramid_call(10, 1) + pyramid_call(400, 11)
              if not e["name"].startswith(("custereo.model.pyramid",
                                           "custereo.pyramid."))]
    assert read(name, summary(events, units=2)) is None


def test_the_least_work_counts_each_level_once():
    cfg = harness.resolve(harness.load_manifest(), CELL).config
    (hc, wc, dc), (h, w, df) = leastwork_pyramid.levels(cfg)
    assert (hc, wc, dc) == (497, 720, 73) and (h, w, df) == (1988, 2880, 24)
    coarse = leastwork.maps(dict(cfg, height=hc, width=wc,
                                 num_disparities=dc), 1)
    fine = leastwork.maps(dict(cfg, num_disparities=df), 1)
    work = leastwork_pyramid.maps(cfg, 1)
    assert work.flops == coarse.flops + fine.flops
    assert work.flops == 44 * (497 * 720 * 74 + 1988 * 2880 * 25)
    # The two images read and the four maps written, at full resolution.
    assert work.bytes == fine.bytes == 4 * 6 * 1988 * 2880
    assert leastwork_pyramid.maps(cfg, 3).flops == 3 * work.flops


@pytest.mark.parametrize("fault", sorted(calibrate_pyramid.FAULTS))
def test_each_fault_makes_the_run_not_correct(fault):
    with calibrate_pyramid.FAULTS[fault]():
        result = tiny.execute(CELL, seed=2 ** 33 + 5)
    assert result["correct"] is False, result["checks"]


def test_a_wrong_shift_shows_in_the_shift_and_its_excuse():
    with calibrate_pyramid.FAULTS["off_by_level"]():
        found = tiny.execute(CELL, seed=2 ** 33 + 5)["checks"]
    assert found["shift_gap"]["value"] > 0.5
    assert found["excused_share"]["value"] > found["excused_share"]["limit"]


def test_the_control_fails_a_number():
    cell = tiny.cell(CELL)
    found = calibrate_pyramid.control(cell, 2 ** 33 + 5, torch.device("cpu"))
    assert not checks.verdict(found), found
    assert set(found) == set(checks_pyramid.NUMBERS)


@pytest.mark.card
def test_the_control_fails_a_number_at_the_cell_own_size(card):
    cell = harness.resolve(harness.load_manifest(), CELL)
    found = calibrate_pyramid.control(cell, 2 ** 31 + 5, card)
    assert not checks.verdict(found), found
