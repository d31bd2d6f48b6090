"""End-to-end demo: stereo pair → disparity map → depth, with metrics.

The counterpart of ``examples/demo.py``: a synthetic structured-light pair
with exact ground truth through ``StereoMatcher.disparity_maps`` (K3 on
the card), its accuracy on confident pixels, metric depth, the
pipeline's device time (``utils.benchmark``, CUDA events; not measured on
the CPU) and, with ``--save-png``, the hard disparity as an 8-bit PNG.

    python -m custereomatching_tpu_torch.examples.demo
    python -m custereomatching_tpu_torch.examples.demo --scene box --save-png disp.png
    python -m custereomatching_tpu_torch.examples.demo --device cpu --height 32 \\
        --width 64 -D 8 -k 5

It runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import make_stereo_pair, save_disparity_png
from custereomatching_tpu_torch.examples.real_capture import to_numpy
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.ops import disparity_to_depth
from custereomatching_tpu_torch.utils import benchmark, disparity_metrics


def main(argv: Optional[List[str]] = None,
         record: Optional[dict] = None) -> int:
    """Run the demo; ``record``, where given, receives the inputs, the
    maps (``[1, H, W]``), the metrics and the latency."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--disparities", "-D", type=int, default=192)
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--scene", choices=["slant", "box"], default="slant")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--save-png", type=str, default=None)
    ap.add_argument("--focal", type=float, default=700.0)
    ap.add_argument("--baseline", type=float, default=0.12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    cam, proj, disp_true = make_stereo_pair(
        args.height, args.width, scene=args.scene, d_min=2.0,
        d_max=min(args.disparities * 0.8, 40.0), noise=args.noise, seed=0)

    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    model = StereoMatcher(config)
    print(f"backend: {config.resolved_backend(device)}  device: {device}")

    cam_b = torch.from_numpy(cam)[None].to(device)
    proj_b = torch.from_numpy(proj)[None].to(device)
    with torch.no_grad():
        maps = to_numpy(model.disparity_maps(cam_b, proj_b))

    m = disparity_metrics(torch.from_numpy(maps.soft_disparity[0]),
                          torch.from_numpy(disp_true),
                          torch.from_numpy(maps.mask[0]))
    print("metrics (soft disparity, confident pixels): "
          + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))

    depth = disparity_to_depth(torch.from_numpy(maps.soft_disparity[0]),
                               args.focal, args.baseline).numpy()
    valid = maps.mask[0] > 0
    if valid.any():
        print(f"depth range over confident pixels: "
              f"[{float(depth[valid].min()):.3f}, "
              f"{float(depth[valid].max()):.3f}] m")

    latency_ms = None
    if device.type == "cuda":
        with torch.no_grad():
            stats = benchmark(model.disparity_maps, cam_b, proj_b, iters=20,
                              warmup=3)
        latency_ms = stats["median_s"] * 1e3
        print(f"pipeline latency: median {latency_ms:.4f} ms device time "
              f"({1e3 / latency_ms:.1f} frames/s, CUDA events)")
    else:
        print("pipeline latency: not measured on the CPU (device time "
              "only)")

    if args.save_png:
        save_disparity_png(args.save_png, maps.disparity[0],
                           max_disparity=args.disparities)
        print(f"wrote {args.save_png}")
    if record is not None:
        record.update(camera=cam, projector=proj, truth=disp_true,
                      maps=maps, metrics=m, latency_ms=latency_ms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
