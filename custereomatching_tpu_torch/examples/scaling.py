"""Mesh-scaling report: throughput and efficiency across mesh shapes.

The counterpart of ``examples/scaling.py``: the sharded pipeline over a
sweep of ``(data, space)`` mesh shapes, every factorization into powers
of two of 1, 2, 4, ... up to the world's ranks, with weak-scaling
efficiency (per-rank workload held constant) or, with ``--strong``, the
sharding overhead at a fixed global size.  A step is timed on the host
clock from a barrier to the barrier after it (the card synchronised), so
it includes the halo exchange.

  torchrun --nproc-per-node 4 -m custereomatching_tpu_torch.examples.scaling
  python -m custereomatching_tpu_torch.examples.scaling --device cpu \\
      --ranks 4 --height 16 --width 64 -D 8 -k 5 --pipeline volume

On the CPU the ranks are spawned gloo processes of one thread each,
sharing the host's cores: the point of that run is the collectives and
the accounting; its times are host times of the plain versions, not a
card's.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from custereomatching_tpu_torch.config import (
    MeshConfig,
    StereoConfig,
    entry_device,
)
from custereomatching_tpu_torch.data import make_video_batch
from custereomatching_tpu_torch.parallel import (
    halo_exchange,
    initialize_multihost,
    make_mesh,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
)
from custereomatching_tpu_torch.parallel.multihost import (
    launch,
    world_rank,
    world_size,
)


# Timed steps a mesh, after the warm-up steps.
ITERS, WARMUP = 10, 2


def mesh_shapes(n: int) -> List[tuple]:
    """Every (data, space) with space in 1, 2, 4, 8 and data · space a
    power of two no larger than ``n``, by size then space."""
    shapes = set()
    d = 1
    while d <= n:
        for s in (1, 2, 4, 8):
            if d * s <= n and (d * s) & (d * s - 1) == 0:
                shapes.add((d, s))
        d *= 2
    return sorted(shapes, key=lambda x: (x[0] * x[1], x[1]))


def step_seconds(fn, device: torch.device, iters: int = ITERS,
                 warmup: int = WARMUP) -> float:
    """Median host seconds of ``fn()`` from a barrier to the barrier after
    it, the card synchronised (every rank of the world calls it)."""
    samples = []
    for i in range(warmup + iters):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        if i >= warmup:
            samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


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
    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    backend = config.resolved_backend(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"ranks: {n} x {device.type} ({kind})  backend: {backend}  "
        f"pipeline: {args.pipeline}")
    shapes = mesh_shapes(n)
    max_d = max(d for d, _ in shapes)
    max_s = max(s for _, s in shapes)
    if args.strong:
        log(f"{'mesh':>10} {'ranks':>8} {'frames/s':>10} {'step ms':>9} "
            f"{'overhead':>9}")
    else:
        log(f"{'mesh':>10} {'ranks':>8} {'frames/s':>10} {'per-rank':>9} "
            f"{'weak-eff':>9}")
    base = None
    for dd, ss in shapes:
        B = args.frames * (max_d if args.strong else dd)
        H = args.height * (max_s if args.strong else ss)
        cams, projs, _ = make_video_batch(B, H, args.width, d_min=2.0,
                                          d_max=12.0)
        mesh = make_mesh(MeshConfig(data=dd, space=ss), device.type)
        if mesh.get_coordinate() is None:
            # Not in this mesh: only the barriers.
            step_seconds(lambda: None, device)
            continue
        cam, proj = shard_batch((torch.from_numpy(cams).to(device),
                                 torch.from_numpy(projs).to(device)), mesh)
        if args.pipeline == "fused":
            fn = lambda: sharded_disparity_maps(  # noqa: E731
                cam, proj, config, mesh).soft_disparity
        else:
            fn = lambda: sharded_cost_volume(cam, proj, config,  # noqa: E731
                                             mesh)
        with torch.no_grad():
            sec = step_seconds(fn, device)
        rate = B / sec
        if args.strong:
            base = sec if base is None else base
            log(f"{dd}x{ss:<8} {dd * ss:>8} {rate:>10.2f} {sec * 1e3:>9.2f} "
                f"{(sec / base - 1.0) * 100:>+8.1f}%")
        else:
            per = rate / (dd * ss)
            base = per if base is None else base
            log(f"{dd}x{ss:<8} {dd * ss:>8} {rate:>10.2f} {per:>9.2f} "
                f"{per / base * 100:>8.1f}%")

    if args.halo_breakdown and max_s > 1:
        # Communication share: the halo exchange alone on the largest
        # space mesh, against the sharded step above.
        dd = max(d for d, s in shapes if s == max_s)
        mesh = make_mesh(MeshConfig(data=dd, space=max_s), device.type)
        B = args.frames * (max_d if args.strong else dd)
        H = args.height * max_s
        if mesh.get_coordinate() is None:
            step_seconds(lambda: None, device)
        else:
            cams, _, _ = make_video_batch(B, H, args.width)
            block = shard_batch(torch.from_numpy(cams).to(device),
                                mesh).to_local()
            group = mesh.get_group(1)
            sec = step_seconds(
                lambda: halo_exchange(block, config.pad, group, axis=1),
                device)
            log(f"halo exchange alone ({dd}x{max_s} mesh, {config.pad} "
                f"rows): {sec * 1e3:.3f} ms (2 sends and 2 receives of "
                f"[{block.shape[0]}, {config.pad}, {args.width}] a rank)")
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=128,
                    help="rows PER space-shard (weak scaling)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=1,
                    help="frames PER data-shard (weak scaling)")
    ap.add_argument("--disparities", "-D", type=int, default=32)
    ap.add_argument("--kernel-size", "-k", type=int, default=9)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--pipeline", choices=["fused", "volume"],
                    default="fused")
    ap.add_argument("--strong", action="store_true",
                    help="fixed GLOBAL problem size: the sharding overhead "
                    "against the one-rank run")
    ap.add_argument("--halo-breakdown", action="store_true",
                    help="also time the halo exchange alone")
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
