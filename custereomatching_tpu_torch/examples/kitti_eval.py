"""KITTI stereo evaluation: benchmark pairs → disparity → EPE.

The counterpart of ``examples/kitti_eval.py``: runs
``StereoMatcher.disparity_maps`` (K3 on the card) over a KITTI 2012/2015
directory (layout autodetected, uint16/256 ground truth), every frame
zero-padded to one bucket, and scores the soft disparity where the ground
truth is valid and the mask is set.  Without a dataset it runs on the
checked-in KITTI-format fixture.

    python -m custereomatching_tpu_torch.examples.kitti_eval --root /path/to/kitti2015
    python -m custereomatching_tpu_torch.examples.kitti_eval --device cpu   # the fixture

Prints one JSON record a frame, an ``aggregate`` record and
``KITTI-EVAL PASS|FAIL``; exit code 0 iff the aggregate EPE is at most
``--max-epe`` and the valid coverage above 0.5.  It runs on the card
unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import kitti
from custereomatching_tpu_torch.examples.real_capture import to_numpy
from custereomatching_tpu_torch.models import StereoMatcher

FIXTURE = str(Path(__file__).resolve().parents[2] / "tests" / "data"
              / "kitti_fixture")


def pad_to(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad [H, W] up to the bucket (frames of a KITTI split vary by
    a few pixels; the zeros change no pixel of the frame's maps)."""
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1])))


def search_range(frames, requested: int) -> int:
    """D: ``requested`` where given; else 192, the standard KITTI range,
    or for a small fixture its ground truth's maximum rounded up to 8."""
    if requested:
        return requested
    gt_max = max((float(np.max(f.gt_disparity)) for f in frames
                  if f.gt_disparity is not None), default=0.0)
    return 192 if gt_max == 0.0 or gt_max > 64 else int(-(-gt_max // 8) * 8)


def main(argv: Optional[List[str]] = None,
         record: Optional[dict] = None) -> int:
    """Run the evaluation; ``record``, where given, receives the padded
    inputs, the maps (``[1, H, W]`` a frame), the records and the
    aggregate."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=FIXTURE,
                    help="KITTI dataset root (default: checked-in fixture)")
    ap.add_argument("--frames", type=int, default=0,
                    help="evaluate only the first N frames (0 = all)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"])
    ap.add_argument("--num-disparities", type=int, default=0,
                    help="disparity band (0 = 192 for real KITTI, GT max "
                         "rounded up for the fixture)")
    ap.add_argument("--kernel-size", type=int, default=15)
    ap.add_argument("--threshold", type=float, default=0.6)
    ap.add_argument("--max-epe", type=float, default=3.0,
                    help="pass threshold on aggregate valid-pixel EPE")
    ap.add_argument("--save-dir", default="",
                    help="write predicted disparities in the KITTI "
                         "submission encoding (uint16 PNG) here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    ids = kitti.list_frames(args.root)
    if args.frames:
        ids = ids[:args.frames]
    if not ids:
        print(f"no frames under {args.root}", file=sys.stderr)
        return 2
    frames = [kitti.load_frame(args.root, fid) for fid in ids]

    # One bucket for the whole split.
    H = max(f.camera.shape[0] for f in frames)
    W = max(f.camera.shape[1] for f in frames)
    D = search_range(frames, args.num_disparities)
    model = StereoMatcher(StereoConfig(
        kernel_size=args.kernel_size, num_disparities=D,
        backend=args.backend, cost_threshold=args.threshold))

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    inputs, all_maps, records = [], [], []
    tot_err = tot_bad = tot_valid = tot_px = 0.0
    for f in frames:
        cam = pad_to(f.camera, H, W)
        proj = pad_to(f.projector, H, W)
        with torch.no_grad():
            maps = to_numpy(model.disparity_maps(
                torch.from_numpy(cam)[None].to(device),
                torch.from_numpy(proj)[None].to(device)))
        inputs.append((cam, proj))
        all_maps.append(maps)
        h, w = f.camera.shape
        soft = maps.soft_disparity[0][:h, :w]
        mask = maps.mask[0][:h, :w] > 0
        rec = {"frame": f.frame_id, "coverage": float(mask.mean())}
        if f.gt_disparity is not None:
            # KITTI protocol: score where the ground truth is valid; the
            # model's confidence (mask) is also required, and its
            # coverage of the valid set reported.
            sel = f.gt_valid & mask
            err = np.abs(soft - f.gt_disparity)[sel]
            rec.update(
                epe=float(err.mean()) if err.size else float("nan"),
                bad3=float((err > 3.0).mean()) if err.size else float("nan"),
                valid_coverage=float(sel.sum() / max(f.gt_valid.sum(), 1)))
            tot_err += float(err.sum())
            tot_bad += float((err > 3.0).sum())
            tot_valid += float(sel.sum())
            tot_px += float(f.gt_valid.sum())
        if args.save_dir:
            kitti.save_kitti_disparity(
                os.path.join(args.save_dir, f"{f.frame_id}.png"),
                soft * mask)
        records.append(rec)
        print(json.dumps(rec))

    if tot_valid:
        agg = {"frames": len(frames), "D": D,
               "epe": tot_err / tot_valid,
               "bad3": tot_bad / tot_valid,
               "valid_coverage": tot_valid / max(tot_px, 1.0)}
        ok = agg["epe"] <= args.max_epe and agg["valid_coverage"] > 0.5
    else:
        agg = "no ground truth found"
        ok = True  # a test split: predictions written, nothing to score
    print(json.dumps({"aggregate": agg}))
    if record is not None:
        record.update(inputs=inputs, maps=all_maps, records=records,
                      aggregate=agg, D=D)
    print("KITTI-EVAL", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
