"""Synthetic structured-light stereo data with ground-truth disparity.

A numpy-only copy of ``custereomatching_tpu/data/synthetic.py``: a random
speckle projector pattern and a camera view of it under a known
disparity field.  The port keeps its own copy because importing
``custereomatching_tpu.data`` first runs ``custereomatching_tpu/__init__``,
which imports jax, and the port must run where jax is not installed.
The tests hold the two copies to equal outputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def speckle_pattern(height: int, width: int, *, dot_density: float = 0.08,
                    dot_sigma: float = 0.8,
                    seed: int = 0) -> np.ndarray:
    """Random-dot speckle pattern like a structured-light projector emits.

    Sparse bright dots blurred with a small Gaussian — locally unique
    texture, which is what makes windowed ZNCC matching well-posed.

    Returns a ``[height, width]`` float32 image in [0, 1].
    """
    rng = np.random.default_rng(seed)
    img = (rng.random((height, width)) < dot_density).astype(np.float32)
    if dot_sigma > 0:
        # np.convolve(mode="same") returns the LONGER of the two inputs;
        # cap the kernel below the image extent so small images work.
        radius = max(1, min(int(3 * dot_sigma),
                            (min(height, width) - 1) // 2))
        x = np.arange(-radius, radius + 1, dtype=np.float32)
        g = np.exp(-0.5 * (x / dot_sigma) ** 2)
        g /= g.sum()
        img = np.apply_along_axis(
            lambda r: np.convolve(r, g, mode="same"), 1, img)
        img = np.apply_along_axis(
            lambda c: np.convolve(c, g, mode="same"), 0, img)
    peak = img.max()
    if peak > 0:
        img = img / peak
    return img.astype(np.float32)


def slanted_plane_disparity(height: int, width: int, *, d_min: float = 2.0,
                            d_max: float = 12.0,
                            axis: int = 1) -> np.ndarray:
    """A smooth planar disparity ramp from ``d_min`` to ``d_max``."""
    n = width if axis == 1 else height
    ramp = np.linspace(d_min, d_max, n, dtype=np.float32)
    if axis == 1:
        return np.broadcast_to(ramp[None, :], (height, width)).copy()
    return np.broadcast_to(ramp[:, None], (height, width)).copy()


def box_scene_disparity(height: int, width: int, *, background: float = 3.0,
                        foreground: float = 10.0) -> np.ndarray:
    """A piecewise-constant scene: a foreground box over a background
    plane — exercises disparity discontinuities (where windowed matching
    is legitimately ambiguous and the confidence mask earns its keep)."""
    disp = np.full((height, width), background, np.float32)
    h0, h1 = height // 4, 3 * height // 4
    w0, w1 = width // 4, 3 * width // 4
    disp[h0:h1, w0:w1] = foreground
    return disp


def render_camera(projector: np.ndarray, disparity: np.ndarray,
                  *, noise: float = 0.0,
                  seed: int = 1) -> np.ndarray:
    """Render the camera view: ``camera[y, x] = projector[y, x − d(y, x)]``.

    Integer disparities sample directly; fractional disparities use
    linear interpolation.  Pixels whose source falls left of the image
    are zero (the same out-of-view convention as the reference's
    zero-padded reads, custma/src/stereo_matching_kernel.cu:6-12).
    """
    H, W = projector.shape
    xs = np.arange(W, dtype=np.float32)[None, :] - disparity
    x0 = np.floor(xs).astype(np.int64)
    frac = xs - x0
    valid0 = (x0 >= 0) & (x0 < W)
    valid1 = (x0 + 1 >= 0) & (x0 + 1 < W)
    rows = np.arange(H)[:, None]
    v0 = np.where(valid0, projector[rows, np.clip(x0, 0, W - 1)], 0.0)
    v1 = np.where(valid1, projector[rows, np.clip(x0 + 1, 0, W - 1)], 0.0)
    cam = (1.0 - frac) * v0 + frac * v1
    if noise > 0:
        rng = np.random.default_rng(seed)
        cam = cam + noise * rng.standard_normal(cam.shape)
    return cam.astype(np.float32)


def make_stereo_pair(
    height: int, width: int, *, scene: str = "slant",
    d_min: float = 2.0, d_max: float = 12.0, noise: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate ``(camera, projector, true_disparity)`` for a test scene.

    Args:
      height, width: image size.
      scene: "slant" (smooth ramp) or "box" (discontinuous).
      d_min, d_max: disparity range of the scene.
      noise: stddev of additive Gaussian camera noise.
      seed: RNG seed.
    """
    projector = speckle_pattern(height, width, seed=seed)
    if scene == "slant":
        disparity = slanted_plane_disparity(height, width, d_min=d_min,
                                            d_max=d_max)
    elif scene == "box":
        disparity = box_scene_disparity(height, width, background=d_min,
                                        foreground=d_max)
    else:
        raise ValueError(f"unknown scene {scene!r}")
    camera = render_camera(projector, disparity, noise=noise, seed=seed + 1)
    return camera, projector, disparity



def make_video_batch(
    num_frames: int, height: int, width: int, *, d_min: float = 2.0,
    d_max: float = 12.0, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch of frames with a drifting disparity plane — the
    keyframe-depth video workload (BASELINE config 4).

    Returns ``(cameras [B,H,W], projectors [B,H,W], disparities [B,H,W])``.
    """
    cams, projs, disps = [], [], []
    for f in range(num_frames):
        shift = (d_max - d_min) * f / max(num_frames - 1, 1) * 0.25
        cam, proj, disp = make_stereo_pair(
            height, width, d_min=d_min + shift, d_max=d_max - shift,
            seed=seed + f)
        cams.append(cam)
        projs.append(proj)
        disps.append(disp)
    return (np.stack(cams), np.stack(projs), np.stack(disps))
