"""Serving loop: warm engine + frame prefetch + failsafe.

The counterpart of ``examples/serve.py``: a stream of camera frames (PNG
files, decoded ahead by the native ``FrameLoader`` where the native
library builds, else one at a time by ``data.load_image_gray``) matched
against a fixed projector pattern by a warm ``StereoEngine`` with one
bucket (the frame rounded up to 64×128) and transient-fault retries (K3
on the card), after a device health probe; per-frame latency on the host
clock, numpy in and numpy out.

    python -m custereomatching_tpu_torch.examples.serve
    python -m custereomatching_tpu_torch.examples.serve --loops 8 --retries 2
    python -m custereomatching_tpu_torch.examples.serve --device cpu

Prints the p50 and p95 latency and ``SERVE: OK`` when every frame was
served.  It runs on the card unless ``--device cpu`` asks for the CPU.
``--autotune`` gives the engine's bucket K3's tile tuned for its shape on
the card during the warmup (``ops.tuning``; the winner persists on disk
across restarts); with ``--device cpu`` there is nothing to tune (the
plain versions have no tile) and it says so.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.data.io import image_decoders, load_image_gray
from custereomatching_tpu_torch.models.engine import StereoEngine

DATA = Path(__file__).resolve().parents[2] / "examples" / "data"


def main(argv: Optional[List[str]] = None,
         record: Optional[dict] = None) -> int:
    """Serve the frames; ``record``, where given, receives the first
    frame and the projector as decoded, every frame's maps, the
    latencies and the frame source."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--camera-pngs", nargs="*", default=None,
                    help="camera frame files (default: the checked-in "
                         "capture, repeated --loops times)")
    ap.add_argument("--projector-png",
                    default=str(DATA / "capture_projector.png"))
    ap.add_argument("--loops", type=int, default=4)
    ap.add_argument("--num-disparities", type=int, default=48)
    ap.add_argument("--kernel-size", type=int, default=15)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune K3's tile for the bucket on first use "
                    "(winners persist across restarts)")
    args = ap.parse_args(argv)

    frames = args.camera_pngs or [
        str(DATA / "capture_camera.png")] * args.loops
    proj = load_image_gray(args.projector_png)
    H, W = proj.shape
    bucket = (-(-H // 64) * 64, -(-W // 128) * 128)

    engine = StereoEngine(
        StereoConfig(kernel_size=args.kernel_size,
                     num_disparities=args.num_disparities,
                     backend=args.backend),
        buckets=[bucket], retries=args.retries, autotune=args.autotune,
        device=args.device)
    if args.autotune and not engine.autotune:
        print(f"autotune: nothing to tune on the "
              f"{engine.config.resolved_backend(engine.device)} backend "
              f"(the plain versions have no tile)")

    if not engine.healthy():
        print("SERVE: device health probe FAILED", file=sys.stderr)
        return 2
    print(f"device {engine.device} healthy; bucket {bucket[0]}x{bucket[1]}, "
          f"retries={args.retries}")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"warmup (kernel build{', tuning' if engine.autotune else ''} + "
          f"one call a bucket) {time.perf_counter() - t0:.1f}s")
    if engine.autotune:
        print(f"autotuned tiles: {engine.tuned_tiles}")

    served, lat, first = [], [], None
    t_stream = time.perf_counter()
    if native.native_available():
        source = native.FrameLoader(frames)
        name = "native FrameLoader"
        print(f"native prefetch loader over {len(frames)} frames")
    else:
        source = (load_image_gray(p) for p in frames)
        name = f"load_image_gray ({image_decoders()[0]})"
        print(f"python decode fallback via {image_decoders()[0]} (native "
              f"library unavailable)")
    try:
        for cam in source:
            t1 = time.perf_counter()
            # numpy maps come back: the copy to the host is the fence.
            maps = engine.infer(cam, proj)
            lat.append(time.perf_counter() - t1)
            served.append(maps)
            if first is None:
                first = cam
    finally:
        if hasattr(source, "close"):
            source.close()
    dt = time.perf_counter() - t_stream
    n = len(served)
    if not n:
        print("SERVE: no frames served", file=sys.stderr)
        return 1
    lat_ms = np.asarray(lat) * 1e3
    p50, p95 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 95)
    cov = float((served[-1].mask > 0).mean())
    print(f"served {n} frames in {dt * 1e3:.0f} ms ({n / max(dt, 1e-9):.1f} "
          f"fps end-to-end incl. host IO, {name}); per-frame p50 "
          f"{p50:.3f} ms / p95 {p95:.3f} ms (host clock, device "
          f"{engine.device}); last coverage {cov:.3f}")
    if record is not None:
        record.update(camera=first, projector=proj, maps=served,
                      latency_ms=lat_ms, fps=n / max(dt, 1e-9),
                      source=name, bucket=bucket)
    ok = n == len(frames)
    print("SERVE: OK" if ok else "SERVE: INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
