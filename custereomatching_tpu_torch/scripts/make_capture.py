"""Render the real-capture-style stereo pair of ``examples/data``.

    python -m custereomatching_tpu_torch.scripts.make_capture --out DIR

The counterpart of ``scripts/make_capture.py``: a 330 x 422 scene (a
slanted floor and two boxes at other depths) lit by a speckle projector,
seen through a camera with realistic degradations (optical blur,
vignetting, gain and offset, sensor noise, 8-bit quantization), from the
port's numpy ``data.synthetic`` and a fixed seed.  Writes into ``DIR``
(required, so the checked-in pair is never overwritten):

  capture_camera.png      8-bit grayscale camera frame
  capture_projector.png   8-bit grayscale speckle pattern
  capture_disparity.npy   float32 ground-truth disparity

The PNGs are written by the data layer's numpy writer
(``data.kitti._write_png_gray``), so their bytes may differ from the
checked-in files (written with PIL) while their decoded samples are the
same; the ``.npy`` is the same byte for byte.  Needs neither a card nor
JAX.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from custereomatching_tpu_torch.data import render_camera, speckle_pattern
from custereomatching_tpu_torch.data.kitti import _write_png_gray

H, W = 330, 422


def _gauss_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, g, "same"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, g, "same"), 0, img)


def render() -> tuple:
    """(camera, projector, disparity) of the capture: the camera and
    projector in [0, 1] before quantization, the disparity float32."""
    rng = np.random.default_rng(2024)

    # Scene: slanted floor + two boxes at different depths.
    disp = np.broadcast_to(
        np.linspace(10.0, 26.0, W, dtype=np.float32)[None, :],
        (H, W)).copy()
    disp[60:170, 60:190] = 34.0
    disp[190:300, 230:360] = 42.0

    proj = speckle_pattern(H, W, dot_density=0.10, dot_sigma=0.9, seed=7)
    cam = render_camera(proj, disp)

    # Camera degradations: PSF blur, vignetting, gain/offset, shot-ish
    # noise; the PNG write quantizes to 8 bits.
    cam = _gauss_blur(cam, 0.6)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r2 = (((yy - H / 2) / (H / 2)) ** 2 + ((xx - W / 2) / (W / 2)) ** 2)
    cam = cam * (1.0 - 0.25 * r2)                    # vignette
    cam = 0.92 * cam + 0.03                          # gain/offset
    cam = cam + 0.012 * rng.standard_normal((H, W)).astype(np.float32)
    cam = np.clip(cam, 0.0, 1.0)
    return cam, proj, disp.astype(np.float32)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True,
                    help="directory to write the pair into")
    args = ap.parse_args(argv)
    cam, proj, disp = render()
    os.makedirs(args.out, exist_ok=True)
    for name, img in (("capture_camera.png", cam),
                      ("capture_projector.png", proj)):
        _write_png_gray(os.path.join(args.out, name),
                        (img * 255).round().astype(np.uint8), 8)
    np.save(os.path.join(args.out, "capture_disparity.npy"), disp)
    print(f"wrote capture pair to {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
