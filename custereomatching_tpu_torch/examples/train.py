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
  torchrun --nproc-per-node 4 -m custereomatching_tpu_torch.examples.train \\
      --mesh 2x2             # sharded over a (data, space) mesh of 4 cards
  python -m custereomatching_tpu_torch.examples.train --device cpu \\
      --mesh 1x2 --ranks 2   # the same on 2 spawned gloo ranks

With ``--mesh`` the camera is a ``DTensor`` sharded over the mesh, the
loss runs the sharded volume (K1 + K2 on each rank's halo-extended block)
and the plain head, and a checkpoint holds the full tensors, so a sharded
run and a single-device run resume each other's.  ``--autotune`` tunes
the tiles of the training kernels for the run's shape on the card before
training (``ops.tuning``: K3w's ``pipeline_blocks``, K4's
``trainable_bwd_block_rows``; the winners persist on disk) and prints
them; with ``--device cpu`` there is nothing to tune (the plain versions
have no tile) and it says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from custereomatching_tpu_torch.config import (
    MeshConfig,
    StereoConfig,
    entry_device,
)
from custereomatching_tpu_torch.data import make_video_batch
from custereomatching_tpu_torch.models import (
    StereoMatcher,
    TrainState,
    adam,
    init_state,
    make_train_step,
)
from custereomatching_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    shard_batch,
)
from custereomatching_tpu_torch.parallel.multihost import (
    launch,
    world_rank,
)
from custereomatching_tpu_torch.utils import disparity_metrics


def _full_tensors(tree):
    """The optimizer state dict with every ``DTensor`` gathered (a
    collective: every rank calls it)."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: _full_tensors(v) for k, v in tree.items()}
    return tree


def _like_camera(tree, camera: torch.Tensor):
    """Full tensors of the camera's shape distributed as the camera is."""
    if isinstance(tree, dict):
        return {k: _like_camera(v, camera) for k, v in tree.items()}
    if (isinstance(camera, DTensor) and isinstance(tree, torch.Tensor)
            and tree.shape == camera.shape):
        return distribute_tensor(tree.to(camera.device), camera.device_mesh,
                                 camera.placements)
    return tree


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    """Write ``step_<n>.pt`` (camera, optimizer state, step) atomically,
    as full tensors (a sharded state is gathered; rank 0 writes)."""
    camera = state.camera.detach()
    if isinstance(camera, DTensor):
        camera = camera.full_tensor()
    optimizer = _full_tensors(state.optimizer.state_dict())
    if world_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
        tmp = path + ".tmp"
        torch.save({"camera": camera.cpu(), "optimizer": optimizer,
                    "step": state.step}, tmp)
        os.replace(tmp, path)
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(ckpt_dir: str, state: TrainState
                       ) -> Optional[TrainState]:
    """The newest checkpoint in ``ckpt_dir`` loaded into ``state``'s
    camera and optimizer (distributed as the camera is), or None when
    there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".pt"))
    if not steps:
        return None
    ckpt = torch.load(os.path.join(ckpt_dir, steps[-1]),
                      map_location=state.camera.device)
    with torch.no_grad():
        state.camera.copy_(_like_camera(ckpt["camera"], state.camera))
    state.optimizer.load_state_dict(_like_camera(ckpt["optimizer"],
                                                 state.camera))
    return state._replace(step=int(ckpt["step"]))


def autotuned_tiles(args: argparse.Namespace, config: StereoConfig,
                    device: torch.device, log) -> dict:
    """The config fields ``--autotune`` sets: the forward's and K4's tiles
    tuned on the card for the run's shape, or none off the ``cuda``
    backend, whose plain versions have no tile."""
    backend = config.resolved_backend(device)
    if backend != "cuda":
        log(f"autotune: nothing to tune on the {backend} backend (the plain "
            f"versions have no tile)")
        return {}
    from custereomatching_tpu_torch.ops import tuning

    shape = (args.height, args.width, args.disparities, args.kernel_size)
    tuned = {"pipeline_blocks": tuning.autotune_pipeline_blocks(*shape),
             "trainable_bwd_block_rows":
                 tuning.autotune_trainable_bwd_blocks(*shape)}
    log(f"autotuned tiles: {tuned}")
    return tuned


def run(args: argparse.Namespace) -> List[str]:
    """Train as ``args`` say; return the report's lines (rank 0 prints
    them as they come when ``echo``)."""
    lines: List[str] = []

    def log(msg: str) -> None:
        lines.append(msg)
        # Spawned ranks' lines are printed by the spawning process.
        if not args.ranks and world_rank() == 0:
            print(msg, flush=True)

    device = entry_device(args.device)
    mesh = None
    if args.mesh:
        d, s = (int(x) for x in args.mesh.split("x"))
        initialize_multihost(device=device)
        mesh = make_mesh(MeshConfig(data=d, space=s), device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    cams, projs, _ = make_video_batch(args.frames, args.height, args.width,
                                      d_min=2.0,
                                      d_max=min(args.disparities * 0.7, 16.0))
    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    if args.autotune:
        config = dataclasses.replace(config, **autotuned_tiles(args, config,
                                                               device, log))
    model = StereoMatcher(config)
    log(f"backend: {config.resolved_backend(device)}  device: {device}")

    true_cam = torch.from_numpy(cams).to(device)
    projector = torch.from_numpy(projs).to(device)
    # Target = the disparity the TRUE camera produces; start from a noisy
    # camera and recover it.
    with torch.no_grad():
        target = model.disparity_maps(true_cam, projector).soft_disparity
    rng = np.random.default_rng(0)
    camera0 = true_cam + args.noise * torch.from_numpy(
        rng.standard_normal(cams.shape).astype(np.float32)).to(device)
    if mesh is not None:
        camera0, projector_s, target_s = shard_batch(
            (camera0, projector, target), mesh)
        log(f"mesh: {mesh}")
    else:
        projector_s, target_s = projector, target

    state = init_state(camera0, adam(args.lr))
    if args.ckpt_dir:
        restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            log(f"resumed from step {state.step}")

    step_fn = make_train_step(model, mesh)
    start = state.step
    for i in range(start, args.steps):
        state, metrics = step_fn(state, projector_s, target_s)
        if (i + 1) % 10 == 0 or i == start:
            log(f"step {i+1:5d}  loss {float(metrics.loss):.6f}  "
                f"|grad| {float(metrics.grad_norm):.4f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state)
            log(f"checkpointed step {i+1}")

    with torch.no_grad():
        camera = state.camera.detach()
        if isinstance(camera, DTensor):
            camera = camera.full_tensor()
        final = model.disparity_maps(camera, projector)
        m = disparity_metrics(final.soft_disparity, target, final.mask)
        log("final disparity-vs-target: "
            + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
        cam_err = float(torch.abs(camera - true_cam).mean())
    log(f"mean |camera - true_camera|: {cam_err:.5f} "
        f"(initial noise σ={args.noise})")
    return lines


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
                    help="'DxS' (data x space) mesh, e.g. 2x2: D*S ranks, "
                    "one a card under torchrun, or --ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --device cpu: spawn this many gloo ranks")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--autotune", action="store_true",
                    help="pick the tiles of the training kernels (forward "
                    "pipeline and trainable backward) for this shape on "
                    "the card before training; winners persist on disk")
    args = ap.parse_args(argv)
    lines = launch(run, args, args.ranks, args.device)
    if args.ranks:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
