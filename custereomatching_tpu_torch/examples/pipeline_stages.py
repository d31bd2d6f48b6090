"""Pipeline-parallel video demo: disparity-range stages over ranks.

The counterpart of ``examples/pipeline_stages.py``: a synthetic frame
stream through
:func:`custereomatching_tpu_torch.parallel.pipeline.pipelined_video_maps`.
Stage ``s`` of ``S`` (one rank each) owns disparity planes
``[s·(D+1)/S, (s+1)·(D+1)/S)`` (K3m on a card) and hands each frame's
partial online-softmax head state (four maps, not a volume) to the next
stage.  The result is checked against the single-device full-range
fused pipeline (``StereoMatcher.disparity_maps``).

  torchrun --nproc-per-node 4 -m custereomatching_tpu_torch.examples.pipeline_stages
  python -m custereomatching_tpu_torch.examples.pipeline_stages \\
      --device cpu --ranks 4 --stages 4     # spawned gloo ranks
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import make_video_batch
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.parallel import (
    initialize_multihost,
    pipelined_video_maps,
    stage_mesh,
)
from custereomatching_tpu_torch.parallel.multihost import (
    launch,
    world_rank,
    world_size,
)
from custereomatching_tpu_torch.utils import disparity_metrics


def run(args: argparse.Namespace) -> List[str]:
    lines: List[str] = []

    def log(msg: str) -> None:
        lines.append(msg)
        # Spawned ranks' lines are printed by the spawning process.
        if not args.ranks and world_rank() == 0:
            print(msg, flush=True)

    device = entry_device(args.device)
    initialize_multihost(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n = world_size()
    S = min(args.stages, n)
    if (args.disparities + 1) % S:
        raise SystemExit(
            f"D+1={args.disparities + 1} must divide into {S} stages")
    cfg = StereoConfig(kernel_size=args.kernel_size,
                       num_disparities=args.disparities, backend=args.backend)
    mesh = stage_mesh(S, device.type)
    log(f"{S} pipeline stages over {n} ranks ({device.type}); "
        f"{args.frames} frames @ {args.height}x{args.width}, "
        f"{args.disparities + 1} planes -> {(args.disparities + 1) // S} "
        f"per stage")
    if mesh.get_coordinate() is None:
        return lines
    cams, projs, disps = make_video_batch(
        args.frames, args.height, args.width, d_min=2.0,
        d_max=max(3.0, args.disparities * 0.6))
    cams = torch.from_numpy(cams).to(device)
    projs = torch.from_numpy(projs).to(device)
    with torch.no_grad():
        piped = pipelined_video_maps(cams, projs, cfg, mesh)
        # The single-device fused pipeline the stages split (K3 on a card).
        # Not the volume path: the fused kernels take the argmax over
        # beta-scaled costs, so at near-ties it may pick another plane
        # than torch.argmax over K1's volume.
        single = StereoMatcher(cfg).disparity_maps(cams, projs)
    hard_eq = bool(torch.equal(piped.disparity, single.disparity))
    soft_err = float(torch.max(torch.abs(piped.soft_disparity
                                         - single.soft_disparity)))
    m = disparity_metrics(piped.soft_disparity,
                          torch.from_numpy(disps).to(device), piped.mask)
    log(f"vs single-device: hard disparity equal={hard_eq}, "
        f"soft max|diff|={soft_err:.2e}")
    log("accuracy vs truth: "
        + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    log("PIPELINE-STAGES " + ("PASS" if hard_eq and soft_err < 1e-3
                              else "FAIL"))
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--disparities", "-D", type=int, default=15,
                    help="D; D+1 planes must divide evenly into stages")
    ap.add_argument("--kernel-size", "-k", type=int, default=7)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; one rank a card under "
                    "torchrun) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --device cpu: spawn this many gloo ranks")
    args = ap.parse_args(argv)
    lines = launch(run, args, args.ranks, args.device)
    if args.ranks:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
