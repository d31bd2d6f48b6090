"""Real-capture check: the checked-in PNG pair → decode → disparity.

The counterpart of ``examples/real_capture.py``: loads the committed
8-bit capture pair and its ground truth from ``examples/data/`` in place
(the native libpng decoder and ``.npy`` reader where the native library
builds, else ``data.load_image_gray`` and ``np.load``), runs
``StereoMatcher.disparity_maps`` (K3 on the card) and scores the soft
disparity on confident pixels.

    python -m custereomatching_tpu_torch.examples.real_capture
    python -m custereomatching_tpu_torch.examples.real_capture --device cpu

Exit code 0 iff the confident-pixel EPE is at most ``--max-epe`` and the
coverage above 0.5 (``REAL-CAPTURE PASS``).  It runs on the card unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data.io import image_decoders, load_image_gray
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps
from custereomatching_tpu_torch.utils.metrics import disparity_metrics

DATA = Path(__file__).resolve().parents[2] / "examples" / "data"


def load_capture():
    """The committed capture pair and its true disparity, and the decoder
    that read them: the native library's where it builds."""
    cam_path = str(DATA / "capture_camera.png")
    proj_path = str(DATA / "capture_projector.png")
    truth_path = str(DATA / "capture_disparity.npy")
    if native.native_available():
        cam = native.decode_png_gray(cam_path)
        proj = native.decode_png_gray(proj_path)
        truth = native.load_npy_f32(truth_path)
        if cam is not None and proj is not None and truth is not None:
            return cam, proj, truth, "native"
    cam = load_image_gray(cam_path)
    proj = load_image_gray(proj_path)
    truth = np.load(truth_path)
    return cam, proj, truth, image_decoders()[0]


def to_numpy(maps: PipelineMaps) -> PipelineMaps:
    return PipelineMaps(*(m.cpu().numpy() for m in maps))


def main(argv: Optional[List[str]] = None,
         record: Optional[dict] = None) -> int:
    """Run the check; ``record``, where given, receives the inputs, the
    maps (``[1, H, W]``) and the metrics."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--num-disparities", type=int, default=48)
    ap.add_argument("--kernel-size", type=int, default=15)
    ap.add_argument("--max-epe", type=float, default=1.0,
                    help="pass threshold on confident-pixel EPE (px)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    cam, proj, truth, decoder = load_capture()
    print(f"loaded capture {cam.shape[0]}x{cam.shape[1]} ({decoder} "
          f"decoder)")

    model = StereoMatcher(StereoConfig(
        kernel_size=args.kernel_size, num_disparities=args.num_disparities,
        backend=args.backend))
    with torch.no_grad():
        maps = to_numpy(model.disparity_maps(
            torch.from_numpy(cam)[None].to(device),
            torch.from_numpy(proj)[None].to(device)))
    m = disparity_metrics(torch.from_numpy(maps.soft_disparity[0]),
                          torch.from_numpy(truth),
                          torch.from_numpy(maps.mask[0]))
    print(f"confident-pixel EPE {m['epe']:.4f} px, bad3 {m['bad3']:.4f}, "
          f"coverage {m['coverage']:.4f} (device {device})")
    ok = m["epe"] <= args.max_epe and m["coverage"] > 0.5
    if record is not None:
        record.update(camera=cam, projector=proj, truth=truth, maps=maps,
                      metrics=m, decoder=decoder)
    print("REAL-CAPTURE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
