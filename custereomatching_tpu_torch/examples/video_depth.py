"""Streaming keyframe depth: a stream of stereo frames in, metric depth out.

The counterpart of ``examples/video_depth.py``.  A synthetic video
sequence (or, with ``--camera-pngs``/``--projector-png``, PNG camera
frames) goes frame by frame through ``StereoMatcher.disparity_maps`` (K3
on the card) and ``disparity_to_depth``; it reports the sustained depth
maps a second and, on the synthetic sequence, the accuracy of the last
frame against its ground truth.  Frames are dispatched as they arrive and
the stream is fenced once at its end, by ``torch.cuda.synchronize()``.

    python -m custereomatching_tpu_torch.examples.video_depth --frames 16
    python -m custereomatching_tpu_torch.examples.video_depth --device cpu \\
        --frames 2 --height 32 --width 64 -D 8 -k 5
    python -m custereomatching_tpu_torch.examples.video_depth \\
        --projector-png proj.png --camera-pngs cam0.png cam1.png

PNG frames stream through the native ``FrameLoader`` (decode overlapping
the card's compute) where the native library builds, else through
``data.load_image_gray``.  It runs on the card unless ``--device cpu``
asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import make_video_batch
from custereomatching_tpu_torch.data.io import image_decoders, load_image_gray
from custereomatching_tpu_torch.examples.real_capture import to_numpy
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.ops import disparity_to_depth
from custereomatching_tpu_torch.utils.metrics import disparity_metrics


def keyframe_depth(model: StereoMatcher, camera: torch.Tensor,
                   projector: torch.Tensor, focal: float, baseline: float):
    """One ``[H, W]`` frame to its depth map and its ``[1, H, W]`` maps."""
    maps = model.disparity_maps(camera[None], projector[None])
    return disparity_to_depth(maps.soft_disparity[0], focal, baseline), maps


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv: Optional[List[str]] = None,
         record: Optional[dict] = None) -> int:
    """Stream the frames; ``record``, where given, receives the last
    frame's inputs, maps and depth and the rate."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--disparities", "-D", type=int, default=192)
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--focal", type=float, default=700.0)
    ap.add_argument("--baseline", type=float, default=0.12)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--camera-pngs", nargs="*", default=None,
                    help="stream camera frames from PNG files; requires "
                         "--projector-png")
    ap.add_argument("--projector-png", default=None)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    model = StereoMatcher(StereoConfig(kernel_size=args.kernel_size,
                                       num_disparities=args.disparities,
                                       backend=args.backend))
    with torch.no_grad():
        if args.camera_pngs:
            return stream_pngs(args, model, device, record)
        return stream_synthetic(args, model, device, record)


def stream_synthetic(args, model: StereoMatcher, device: torch.device,
                     record: Optional[dict]) -> int:
    cams, projs, disps = make_video_batch(
        args.frames, args.height, args.width, d_min=4.0,
        d_max=min(args.disparities * 0.6, 40.0))
    print(f"backend: {model.config.resolved_backend(device)}  device: "
          f"{device}  frames: {args.frames} @ {args.height}x{args.width}")

    # The sequence is staged on the device first: this measures the
    # pipeline, not the host bus.
    cams_d = [torch.from_numpy(c).to(device) for c in cams]
    projs_d = [torch.from_numpy(p).to(device) for p in projs]

    # Warm up (kernel build), then stream like a SLAM front-end: each
    # frame dispatched as it arrives, one fence at the end.
    keyframe_depth(model, cams_d[0], projs_d[0], args.focal, args.baseline)
    sync(device)
    outputs = []
    t0 = time.perf_counter()
    for f in range(args.frames):
        outputs.append(keyframe_depth(model, cams_d[f], projs_d[f],
                                      args.focal, args.baseline))
    sync(device)
    dt = time.perf_counter() - t0
    rate = args.frames / dt
    print(f"streamed {args.frames} keyframes in {dt * 1e3:.1f} ms "
          f"-> {rate:.1f} depth maps/s ({dt / args.frames * 1e3:.2f} "
          f"ms/frame, host clock, device {device})")

    # Accuracy against the ground truth (last frame).
    depth, maps = outputs[-1]
    soft, mask = maps.soft_disparity[0].cpu(), maps.mask[0].cpu()
    truth = torch.from_numpy(disps[-1])
    m = disparity_metrics(soft, truth, mask)
    depth_true = disparity_to_depth(truth, args.focal, args.baseline)
    valid = mask.numpy() > 0
    derr = np.abs(depth.cpu().numpy() - depth_true.numpy())[valid]
    print("disparity: " + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    if derr.size:
        print(f"depth |err|: mean {derr.mean():.4f} m, p95 "
              f"{np.percentile(derr, 95):.4f} m over confident pixels")
    if record is not None:
        record.update(camera=cams[-1], projector=projs[-1],
                      maps=to_numpy(maps),
                      depth=depth.cpu().numpy(), rate=rate, metrics=m)
    return 0


def stream_pngs(args, model: StereoMatcher, device: torch.device,
                record: Optional[dict]) -> int:
    if not args.projector_png:
        raise SystemExit("--camera-pngs requires --projector-png")
    proj_np = load_image_gray(args.projector_png)
    proj = torch.from_numpy(proj_np).to(device)
    if native.native_available():
        source = native.FrameLoader(args.camera_pngs)
        name = "native FrameLoader (decode overlapping compute)"
    else:
        source = (load_image_gray(p) for p in args.camera_pngs)
        name = (f"load_image_gray via {image_decoders()[0]} (native library "
                f"unavailable)")
    n, depth, maps, cam = 0, None, None, None
    t0 = time.perf_counter()
    try:
        for cam in source:
            depth, maps = keyframe_depth(
                model, torch.from_numpy(cam).to(device), proj, args.focal,
                args.baseline)
            n += 1
    finally:
        if hasattr(source, "close"):
            source.close()
    sync(device)
    dt = time.perf_counter() - t0
    print(f"streamed {n} PNG keyframes in {dt * 1e3:.1f} ms "
          f"-> {n / max(dt, 1e-9):.1f} depth maps/s (host clock, device "
          f"{device}; frames by {name})")
    if record is not None and maps is not None:
        record.update(camera=cam, projector=proj_np,
                      maps=to_numpy(maps),
                      depth=depth.cpu().numpy(), rate=n / max(dt, 1e-9),
                      source=name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
