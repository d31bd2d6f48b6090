"""Camera-image optimisation with checkpoint/resume (PyTorch port).

The counterpart of ``examples/train.py``: Adam over the camera frames
against a target disparity map, the trainable fused pipeline (kernels K3w
and K4) on a CUDA card, and ``torch.save`` checkpoints so that a killed run
resumes where it stopped.  It runs on the card; ``--device cpu`` runs the
plain versions on the CPU instead (without a card and without it, it
raises).

Usage:
  python -m custereomatching_tpu_torch.examples.train --steps 200
  python -m custereomatching_tpu_torch.examples.train --steps 400 \\
      --ckpt-dir ckpt        # resumes from the newest step in ckpt/
  python -m custereomatching_tpu_torch.examples.train --device cpu \\
      --height 16 --width 48 -D 6 -k 5 --steps 3

``--mesh`` and ``--autotune`` are accepted and raise: the parallel layer
and the tile autotuner are not ported yet (ROADMAP items 13 and 12).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import make_video_batch
from custereomatching_tpu_torch.models import (
    StereoMatcher,
    TrainState,
    adam,
    init_state,
    make_train_step,
)
from custereomatching_tpu_torch.utils import disparity_metrics


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    """Write ``step_<n>.pt`` (camera, optimizer state, step) atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"camera": state.camera.detach().cpu(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(ckpt_dir: str, state: TrainState
                       ) -> Optional[TrainState]:
    """The newest checkpoint in ``ckpt_dir`` loaded into ``state``'s
    camera and optimizer, or None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".pt"))
    if not steps:
        return None
    ckpt = torch.load(os.path.join(ckpt_dir, steps[-1]),
                      map_location=state.camera.device)
    with torch.no_grad():
        state.camera.copy_(ckpt["camera"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    return state._replace(step=int(ckpt["step"]))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--disparities", "-D", type=int, default=24)
    ap.add_argument("--kernel-size", "-k", type=int, default=9)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", type=str, default=None,
                    help="not ported yet (ROADMAP item 13)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--autotune", action="store_true",
                    help="not ported yet (ROADMAP item 12)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the parallel layer is not ported yet (ROADMAP item 13)")
    if args.autotune:
        raise NotImplementedError(
            "--autotune: the tile autotuner is not ported yet (ROADMAP "
            "item 12)")

    device = entry_device(args.device)
    cams, projs, _ = make_video_batch(args.frames, args.height, args.width,
                                      d_min=2.0,
                                      d_max=min(args.disparities * 0.7, 16.0))
    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    model = StereoMatcher(config)
    print(f"backend: {config.resolved_backend(device)}  device: {device}")

    true_cam = torch.from_numpy(cams).to(device)
    projector = torch.from_numpy(projs).to(device)
    # Target = the disparity the TRUE camera produces; start from a noisy
    # camera and recover it.
    with torch.no_grad():
        target = model.disparity_maps(true_cam, projector).soft_disparity
    rng = np.random.default_rng(0)
    camera0 = true_cam + args.noise * torch.from_numpy(
        rng.standard_normal(cams.shape).astype(np.float32)).to(device)

    state = init_state(camera0, adam(args.lr))
    if args.ckpt_dir:
        restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed from step {state.step}")

    step_fn = make_train_step(model)
    start = state.step
    for i in range(start, args.steps):
        state, metrics = step_fn(state, projector, target)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:5d}  loss {float(metrics.loss):.6f}  "
                  f"|grad| {float(metrics.grad_norm):.4f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state)
            print(f"checkpointed step {i+1}")

    with torch.no_grad():
        final = model.disparity_maps(state.camera, projector)
        m = disparity_metrics(final.soft_disparity, target, final.mask)
        print("final disparity-vs-target: "
              + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
        cam_err = float(torch.abs(state.camera - true_cam).mean())
    print(f"mean |camera - true_camera|: {cam_err:.5f} "
          f"(initial noise σ={args.noise})")


if __name__ == "__main__":
    main()
