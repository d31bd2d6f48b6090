"""PyTorch port: ``python -m custereomatching_tpu_torch.bench`` on the CPU at
tiny shapes (the plain versions; chains of 1 and 2 calls).

Its one stdout line, its refusals (no card; a failing measurement), its
parity check and pyramid accuracy against the JAX package's calls on the
same scene (``StereoMatcher.disparity_maps`` / ``PyramidStereoMatcher``
and ``disparity_metrics``, the forward tolerance rtol 1e-4 / atol 1e-5),
its bounds against ``utils.profiling`` and the JAX bench's byte formula at
KITTI, and the smoke record it reads.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu import StereoConfig as JaxStereoConfig
from custereomatching_tpu.data import make_stereo_pair as jax_stereo_pair
from custereomatching_tpu.models import (
    PyramidStereoMatcher as JaxPyramidStereoMatcher,
)
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.utils import disparity_metrics as jax_metrics
from custereomatching_tpu_torch import bench
from custereomatching_tpu_torch.utils.profiling import (
    PEAK_BYTES,
    allpairs_bound,
    banded_bounds,
)

TINY = ["--height", "24", "--width", "40", "-D", "8", "-k", "5",
        "--chains", "1", "2", "--repeats", "1", "--allpairs", "16", "24"]
CPU = TINY + ["--device", "cpu"]
# Every measurement of the JAX bench's rows 4-16, by its name.
SECONDARY = (
    "pipeline_ms", "pipeline_bound_ms", "pipeline_model_ms",
    "batched_b4_ms_per_frame", "batched_b4_frames_per_s",
    "batched_b4_bound_ms_per_frame", "batched_b4_model_ms_per_frame",
    "pyramid_ms", "pyramid_frames_per_s",
    "train_step_ms", "train_step_bound_ms", "train_step_model_ms",
    "volume_parity_fwd_ms", "volume_parity_fwd_bound_ms",
    "volume_parity_fwd_model_ms", "volume_parity_fwd_bwd_ms",
    "volume_parity_fwd_bwd_bound_ms", "volume_parity_fwd_bwd_model_ms",
    "volume_hdw_fwd_ms", "volume_hdw_fwd_bound_ms",
    "volume_hdw_fwd_model_ms", "volume_hdw_fwd_bwd_ms",
    "volume_hdw_fwd_bwd_bound_ms", "volume_hdw_fwd_bwd_model_ms",
    "speed_of_light_frames_per_s", "speed_of_light_ms",
    "allpairs_fwd_ms", "allpairs_fwd_bound_ms", "allpairs_fwd_model_ms",
    "allpairs_fwd_bwd_ms", "allpairs_bwd_ms", "allpairs_bwd_bound_ms",
    "pyramid_epe_px", "pyramid_bad3", "pyramid_coverage",
    "stage_op_ms", "stage_op_bound_ms", "stage_op_model_ms",
    "engine_bucket_ms", "engine_bucket_bound_ms", "engine_bucket_model_ms",
    "engine_bucket_frames_per_s",
    "e2e_ms_per_frame", "e2e_frames_per_s", "e2e_decode_ms_per_frame",
    "e2e_decoder",
    "parity_epe_px", "parity_bad3", "parity_coverage",
    "parity_max_hard_diff", "parity_differing_pixels",
    "parity_differing_top2_ties", "parity_differing_threshold_flips",
    "projector_grad_ms", "projector_grad_bound_ms",
    "projector_grad_model_ms", "both_grads_step_ms",
    "both_grads_step_bound_ms", "both_grads_step_model_ms",
)
TOL = dict(rtol=1e-4, atol=1e-5)


def cpu_run(shape):
    H, W, D, k = shape
    args = bench.parse_args(["--height", str(H), "--width", str(W), "-D",
                             str(D), "-k", str(k), "--chains", "1", "2",
                             "--repeats", "1", "--device", "cpu"])
    return bench.setup(args, torch.device("cpu"))


def test_cpu_run_prints_one_json_line(capsys):
    """(a) Under ``--device cpu`` stdout is exactly one line, the JSON
    summary: JAX's four keys, the device (platform "cpu") and every
    secondary measurement; no model is priced off the card."""
    assert bench.main(CPU) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 1 and out.endswith("\n")
    summary = json.loads(lines[0])
    assert summary["metric"] == "kitti_stereo_pipeline_frames_per_s_per_chip"
    assert summary["unit"] == "frames/s"
    assert summary["value"] > 0 and summary["vs_baseline"] > 0
    assert summary["device"] == {"name": "cpu", "power_limit_w": None,
                                 "platform": "cpu"}
    sec = summary["secondary"]
    assert set(sec) == set(SECONDARY)
    assert summary["value"] == pytest.approx(1e3 / sec["pipeline_ms"])
    assert summary["vs_baseline"] == pytest.approx(
        summary["value"] * sec["pipeline_bound_ms"] / 1e3)
    for name in SECONDARY:
        if name.endswith("_model_ms") or name.endswith(
                "_model_ms_per_frame"):
            assert sec[name] is None, name
        elif name != "e2e_decoder":
            assert np.isfinite(sec[name]) and sec[name] >= 0, name
    assert sec["parity_differing_pixels"] == (
        sec["parity_differing_top2_ties"]
        + sec["parity_differing_threshold_flips"])


def test_no_card_exits_before_measuring(monkeypatch, capsys):
    """(b) Without a card and without ``--device cpu`` the bench exits
    non-zero and prints nothing on stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("measured without a card")

    monkeypatch.setattr(bench, "setup", never)
    assert bench.main(TINY) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


@pytest.mark.parametrize("name", ["measure_batched",
                                  "measure_projector_grad"])
def test_failing_measurement_fails_the_run(monkeypatch, capsys, name):
    """(c) A secondary measurement that raises fails the run: exit 1, no
    JSON line (the first and the last of them)."""
    def broken(run):
        raise RuntimeError("injected failure")

    monkeypatch.setattr(bench, name, broken)
    assert bench.main(CPU) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "injected failure" in captured.err


@pytest.mark.parametrize("shape", [(24, 40, 8, 5), (37, 61, 12, 7)])
def test_parity_check_matches_jax(shape):
    """(d) The parity check's EPE, bad3 and coverage on the scene equal
    those of the JAX bench's calls (``bench.py:109-130``) on the same
    scene; its hard disparity differs from the plain path's only at
    top-two ties or threshold flips."""
    H, W, D, k = shape
    run = cpu_run(shape)
    got = bench.measure_parity(run)
    d_max = max(4.0, min(40.0, 0.6 * D))
    cam, proj, truth = jax_stereo_pair(H, W, d_min=4.0, d_max=d_max,
                                       noise=0.01, seed=0)
    for a, b in zip((cam, proj, truth), run.scene(seed=0)):
        np.testing.assert_array_equal(a, b)
    model = JaxStereoMatcher(JaxStereoConfig(kernel_size=k,
                                             num_disparities=D))
    maps = model.disparity_maps(jnp.asarray(cam)[None],
                                jnp.asarray(proj)[None])
    want = jax_metrics(maps.soft_disparity[0], jnp.asarray(truth),
                       maps.mask[0])
    np.testing.assert_allclose(got["parity_epe_px"], want["epe"], **TOL)
    np.testing.assert_allclose(got["parity_bad3"], want["bad3"], **TOL)
    np.testing.assert_allclose(got["parity_coverage"], want["coverage"],
                               **TOL)
    assert got["parity_differing_pixels"] == (
        got["parity_differing_top2_ties"]
        + got["parity_differing_threshold_flips"])


def test_pyramid_accuracy_matches_jax():
    """Row 11: the pyramid's EPE, bad3 and coverage on the scene equal the
    JAX ``PyramidStereoMatcher``'s (``bench.py:201-214``)."""
    H, W, D, k = shape = (32, 64, 16, 5)
    run = cpu_run(shape)
    got = bench.measure_pyramid_accuracy(run)
    cam, proj, truth = run.scene(seed=0)
    pyr = JaxPyramidStereoMatcher(JaxStereoConfig(kernel_size=k,
                                                  num_disparities=D))
    maps = pyr(jnp.asarray(cam)[None], jnp.asarray(proj)[None])
    want = jax_metrics(maps.soft_disparity[0], jnp.asarray(truth),
                       maps.mask[0])
    np.testing.assert_allclose(got["pyramid_epe_px"], want["epe"], **TOL)
    np.testing.assert_allclose(got["pyramid_bad3"], want["bad3"], **TOL)
    np.testing.assert_allclose(got["pyramid_coverage"], want["coverage"],
                               **TOL)


def test_bounds_at_kitti():
    """(e) Rows 3, 9, 10 and 12 at KITTI: the headline's bound is K3's
    least work, the speed of light the JAX bench's bytes
    (``bench.py:642-644``: the volume and two images) at the published
    rate, all-pairs ``allpairs_bound`` at 330x422, the stage op K3m's
    over ceil(193 / 4) = 49 planes; every path a sum of
    ``banded_bounds`` entries."""
    H, W, D, K = 375, 1242, 192, 15
    b = {key: ms for key, (ms, _) in banded_bounds(1, H, W, D, K).items()}
    got = bench.path_bounds(H, W, D, K)
    assert got["pipeline"] == b["K3"] == pytest.approx(0.0590, abs=1e-4)
    assert got["batched_b4"] == pytest.approx(b["K3"])
    assert got["train_step"] == b["K3w"] + b["K4"]
    assert got["volume_parity_fwd"] == got["volume_hdw_fwd"] == b["K1"]
    assert got["volume_parity_fwd_bwd"] == b["K1"] + b["K9b"] + b["K2"]
    assert got["volume_hdw_fwd_bwd"] == b["K1"] + b["K2"]
    assert got["projector_grad"] == b["K7"]
    assert got["both_grads_step"] == b["K1"] + b["K2"] + b["K7"]
    assert got["allpairs_fwd"] == allpairs_bound(1, 330, 422, K)[0]
    n = 330 * 422 * 422
    assert got["allpairs_bwd"] == pytest.approx(
        1e3 * ((2 * n + 3 * 330 * 422) * 4) / PEAK_BYTES)
    assert got["stage_op"] == banded_bounds(1, H, W, 48, K)["K3m"][0]
    assert bench.engine_bucket(H, W) == (384, 1280)
    assert got["engine_bucket"] == banded_bounds(1, 384, 1280, D, K)["K3"][0]
    volume_bytes = H * W * (D + 1) * 4
    image_bytes = 2 * H * W * 4
    nbytes, fps = bench.speed_of_light(H, W, D, PEAK_BYTES)
    assert nbytes == volume_bytes + image_bytes
    assert fps == PEAK_BYTES / (volume_bytes + image_bytes)
    assert set(bench.path_costs(H, W, D, K)) <= set(got)


def test_smoke_record(tmp_path, monkeypatch):
    """Row 19: the record ``chip_smoke.py`` writes is read back without a
    warning on the same card; missing, failed, another card, stale, or
    older than the kernel sources, each warns."""
    path = tmp_path / "smoke.json"
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert len(bench.smoke_status("NVIDIA H100 80GB HBM3", path)) == 1
    bench.write_smoke_record(True, card, path)
    rec = json.loads(path.read_text())
    assert rec["device"] == "NVIDIA H100 80GB HBM3"
    assert rec["power_limit"] == "700.00 W"
    assert bench.smoke_status("NVIDIA H100 80GB HBM3", path) == []
    assert len(bench.smoke_status("NVIDIA A100", path)) == 1
    bench.write_smoke_record(False, card, path)
    assert len(bench.smoke_status("NVIDIA H100 80GB HBM3", path)) == 1
    rec = json.loads(path.read_text())
    rec.update({"pass": True, "unix_time": time.time() - 30 * 86400.0,
                "sources_digest": "0" * 64})
    path.write_text(json.dumps(rec))
    assert len(bench.smoke_status("NVIDIA H100 80GB HBM3", path)) == 2


def test_preflight_fails_without_a_card():
    """Row 18: the probe runs in a subprocess; without a card it exits 1
    on both attempts, and the preflight fails."""
    assert not bench.preflight(attempts=2, wait_s=0.0, timeout_s=120.0)
