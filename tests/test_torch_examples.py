"""PyTorch port: the five data-driven examples (``real_capture``,
``kitti_eval``, ``serve``, ``video_depth``, ``demo``) run in process
through their ``main(argv)`` on the CPU at small sizes, their maps held
against the JAX package's ``StereoMatcher(backend="xla").disparity_maps``
on the same frames.

Hard disparity and mask equal, except a disparity at a top-two tie (the
two largest costs within 1e-5) or a mask within 1e-5 of the threshold;
soft disparity rtol 1e-4 / atol 1e-5 where the masks agree; confidence
rtol / atol 1e-5; aggregate EPE within 1e-3 px of the JAX maps' EPE.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu import StereoConfig as JaxStereoConfig
from custereomatching_tpu import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.data import io, kitti
from custereomatching_tpu_torch.examples import (
    demo,
    kitti_eval,
    real_capture,
    serve,
    video_depth,
)
from custereomatching_tpu_torch.ops.zncc import forward_banded

THRESHOLD = 0.6


def jax_maps(cam, proj, D, k, threshold=THRESHOLD):
    """The JAX package's maps of one ``[H, W]`` pair, as numpy."""
    model = JaxStereoMatcher(JaxStereoConfig(
        kernel_size=k, num_disparities=D, backend="xla",
        cost_threshold=threshold))
    out = model.disparity_maps(jnp.asarray(cam)[None], jnp.asarray(proj)[None])
    return {name: np.asarray(getattr(out, name))[0] for name in out._fields}


def hold(got, cam, proj, D, k, threshold=THRESHOLD):
    """Hold the port's maps of one frame (``PipelineMaps`` of ``[1, H, W]``
    or ``[H, W]`` arrays) against JAX's; returns JAX's maps."""
    want = jax_maps(cam, proj, D, k, threshold)
    got = {name: np.asarray(getattr(got, name)).reshape(want[name].shape)
           for name in want}
    cost = forward_banded(torch.from_numpy(cam)[None],
                          torch.from_numpy(proj)[None], D, k)[0]
    if D:
        top2 = torch.topk(cost, 2, dim=-1).values
        tie = ((top2[..., 0] - top2[..., 1]) <= 1e-5).numpy()
    else:
        tie = np.zeros(cam.shape, bool)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               rtol=1e-5, atol=1e-5)
    flips = got["mask"] != want["mask"]
    assert (np.abs(want["confidence"] - threshold)[flips] <= 1e-5).all()
    differ = got["disparity"] != want["disparity"]
    assert not (differ & ~flips & ~tie).any(), "disparity off a top-two tie"
    same = ~flips
    np.testing.assert_allclose(got["soft_disparity"][same],
                               want["soft_disparity"][same],
                               rtol=1e-4, atol=1e-5)
    return want


def confident_epe(soft, truth, mask):
    m = mask > 0
    return float(np.abs(soft - truth)[m].mean())


def test_real_capture_matches_jax(capsys):
    """The checked-in 330x422 capture at D = 48, k = 15."""
    rec = {}
    assert real_capture.main(["--device", "cpu"], rec) == 0
    out = capsys.readouterr().out
    assert "REAL-CAPTURE PASS" in out
    assert rec["decoder"] == "native" and rec["camera"].shape == (330, 422)
    want = hold(rec["maps"], rec["camera"], rec["projector"], 48, 15)
    assert abs(rec["metrics"]["epe"] - confident_epe(
        want["soft_disparity"], rec["truth"], want["mask"])) <= 1e-3
    assert rec["metrics"]["epe"] <= 1.0 and rec["metrics"]["coverage"] > 0.5


@pytest.mark.parametrize("argv,D", [(["--kernel-size", "9"], 16),
                                    (["--kernel-size", "5", "--frames", "1",
                                      "--num-disparities", "12"], 12)])
def test_kitti_eval_matches_jax(tmp_path, capsys, argv, D):
    """The checked-in fixture: every frame's maps against JAX's, the
    aggregate EPE against the JAX maps', the saved KITTI encoding."""
    rec = {}
    save = tmp_path / "pred"
    assert kitti_eval.main(argv + ["--device", "cpu", "--save-dir",
                                   str(save)], rec) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "KITTI-EVAL PASS"
    agg = json.loads(lines[-2])["aggregate"]
    assert agg == rec["aggregate"] and agg["D"] == D == rec["D"]
    k = int(argv[1])
    ids = kitti.list_frames(kitti_eval.FIXTURE)[:len(rec["maps"])]
    err = n = 0.0
    for fid, (cam, proj), maps in zip(ids, rec["inputs"], rec["maps"]):
        want = hold(maps, cam, proj, D, k)
        fr = kitti.load_frame(kitti_eval.FIXTURE, fid)
        sel = fr.gt_valid & (want["mask"] > 0)
        err += float(np.abs(want["soft_disparity"] - fr.gt_disparity)[sel]
                     .sum())
        n += float(sel.sum())
        saved, _ = kitti.load_kitti_disparity(str(save / f"{fid}.png"))
        enc = np.round(maps.soft_disparity[0] * (maps.mask[0] > 0) * 256)
        np.testing.assert_array_equal(saved, enc.astype(np.float32) / 256)
    assert abs(agg["epe"] - err / n) <= 1e-3


@pytest.mark.parametrize("source", ["native", "fallback"])
def test_serve_matches_jax(monkeypatch, capsys, source):
    """Two capture frames through the engine (bucket 384x512), from the
    native FrameLoader or, without the native library, load_image_gray."""
    if source == "fallback":
        monkeypatch.setattr(native, "native_available", lambda: False)
    rec = {}
    assert serve.main(["--device", "cpu", "--loops", "2",
                       "--num-disparities", "16", "--kernel-size", "7"],
                      rec) == 0
    out = capsys.readouterr().out
    assert "SERVE: OK" in out and "p95" in out
    assert rec["bucket"] == (384, 512) and len(rec["maps"]) == 2
    assert rec["source"].startswith(
        "native FrameLoader" if source == "native" else "load_image_gray")
    want = hold(rec["maps"][0], rec["camera"], rec["projector"], 16, 7)
    for name in want:
        np.testing.assert_array_equal(getattr(rec["maps"][1], name),
                                      getattr(rec["maps"][0], name))
    assert rec["camera"].shape == rec["maps"][0].mask.shape == (330, 422)


def test_serve_autotune_on_the_cpu_serves_untuned(capsys):
    """``--autotune`` on the CPU: there is no tile to tune, so it says so
    and serves."""
    assert serve.main(["--device", "cpu", "--autotune", "--loops", "1",
                       "--num-disparities", "8", "--kernel-size", "5"]) == 0
    out = capsys.readouterr().out
    assert "autotune: nothing to tune on the torch backend" in out
    assert "SERVE: OK" in out


def test_video_depth_synthetic_matches_jax(capsys):
    rec = {}
    assert video_depth.main(["--device", "cpu", "--frames", "2", "--height",
                             "32", "--width", "64", "-D", "8", "-k", "5"],
                            rec) == 0
    assert "depth maps/s" in capsys.readouterr().out
    want = hold(rec["maps"], rec["camera"], rec["projector"], 8, 5)
    depth = np.where(want["soft_disparity"] >= 1e-3,
                     700.0 * 0.12 / np.maximum(want["soft_disparity"], 1e-3),
                     0.0)
    np.testing.assert_allclose(rec["depth"], depth, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("source", ["native", "fallback"])
def test_video_depth_png_streaming_matches_jax(tmp_path, monkeypatch,
                                               capsys, source):
    if source == "fallback":
        monkeypatch.setattr(native, "native_available", lambda: False)
    rng = np.random.default_rng(5)
    proj = (rng.random((32, 64)) * 255).astype(np.uint8)
    proj_path = str(tmp_path / "proj.png")
    kitti._write_png_gray(proj_path, proj, 8)
    cams = []
    for i in range(3):
        p = str(tmp_path / f"cam{i}.png")
        kitti._write_png_gray(
            p, (rng.random((32, 64)) * 255).astype(np.uint8), 8)
        cams.append(p)
    rec = {}
    assert video_depth.main(["--device", "cpu", "-D", "8", "-k", "5",
                             "--projector-png", proj_path,
                             "--camera-pngs"] + cams, rec) == 0
    assert "streamed 3 PNG keyframes" in capsys.readouterr().out
    assert rec["source"].startswith(
        "native FrameLoader" if source == "native" else "load_image_gray")
    np.testing.assert_array_equal(rec["camera"], io.load_image_gray(cams[-1]))
    hold(rec["maps"], rec["camera"], rec["projector"], 8, 5)


def test_demo_matches_jax(tmp_path, capsys):
    png = str(tmp_path / "disp.png")
    rec = {}
    assert demo.main(["--device", "cpu", "--height", "32", "--width", "64",
                      "-D", "8", "-k", "5", "--save-png", png], rec) == 0
    out = capsys.readouterr().out
    assert "pipeline latency: not measured on the CPU" in out
    assert rec["latency_ms"] is None
    want = hold(rec["maps"], rec["camera"], rec["projector"], 8, 5)
    assert abs(rec["metrics"]["epe"] - confident_epe(
        want["soft_disparity"], rec["truth"], want["mask"])) <= 1e-3
    enc = np.clip(rec["maps"].disparity[0] / 8 * 255.0, 0, 255).astype(
        np.uint8)
    np.testing.assert_array_equal(io.decode_png_u16(png), enc)


@pytest.mark.parametrize("name", ["real_capture", "kitti_eval", "serve",
                                  "video_depth", "demo"])
def test_examples_run_on_the_card_unless_asked(name):
    """Without ``--device cpu`` an example runs on the card, and without
    one it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    module = importlib.import_module(
        f"custereomatching_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])

