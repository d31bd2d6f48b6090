"""Multi-rank check of the parallel layer: one process a card (NCCL), or
gloo ranks on the CPU.

    torchrun --nproc-per-node 4 -m custereomatching_tpu_torch.scripts.mesh_check
    python -m custereomatching_tpu_torch.scripts.mesh_check --device cpu \\
        --ranks 4 --height 32 --width 64 -D 12 -k 5

Every rank makes the same seeded speckle pairs.  For every ``(data,
space)`` mesh of the world's ranks (``examples/scaling.py``'s sweep), the
gathered sharded volume (K1 on each halo-extended block) and sharded
fused maps (K3) must equal the unsharded calls on the rank's own card bit
for bit; the camera gradient of the mean soft disparity through the
sharded volume (K1 + K2, halo gradients sent back to their owners) and
through the sharded trainable pipeline (K3w + K4) must be within rtol
1e-3 / atol 1e-6 of the unsharded one (norm-relative <= 1e-4);
``halo_exchange`` must deliver the global rows.  The stage pipeline
(K3m a stage) at every S dividing the world and D + 1 must give the
full-range K3 maps (disparity and mask equal, soft disparity and
confidence within rtol 1e-4 / atol 1e-5).  The sharded fused maps are
timed on the host clock from a barrier to a barrier at each mesh.  Rank
0 prints a line a check and, last, a JSON summary; the exit code is 1 if
any check failed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from custereomatching_tpu_torch.config import (
    MeshConfig,
    StereoConfig,
    entry_device,
)
from custereomatching_tpu_torch.data import make_stereo_pair
from custereomatching_tpu_torch.examples.scaling import (
    mesh_shapes,
    step_seconds,
)
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.ops.cuda_pipeline import stereo_pipeline_cuda
from custereomatching_tpu_torch.parallel import (
    halo_exchange,
    initialize_multihost,
    make_mesh,
    pipelined_video_maps,
    shard_batch,
    sharded_disparity_maps,
    stage_mesh,
)
from custereomatching_tpu_torch.parallel.multihost import (
    launch,
    world_rank,
    world_size,
)


def _close(got, want, rtol, atol, norm_rel=None):
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    rel = float(diff.norm() / want.norm()) if want.norm() > 0 else 0.0
    if norm_rel is not None:
        ok = ok and rel <= norm_rel
    return ok, float(diff.max()), rel


def run(args: argparse.Namespace) -> dict:
    device = entry_device(args.device)
    initialize_multihost(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n = world_size()
    B, H, W, D, k = (args.frames, args.height, args.width, args.disparities,
                     args.kernel_size)
    pairs = [make_stereo_pair(H, W, d_min=2.0, d_max=0.9 * D, seed=i)
             for i in range(B)]
    cam, proj, _ = (torch.from_numpy(np.stack(x)).to(device)
                    for x in zip(*pairs))
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    model = StereoMatcher(cfg)
    checks, times = [], {}

    def check(ok: bool, what: str, detail: str = "") -> None:
        checks.append((bool(ok), what, detail))

    with torch.no_grad():
        want_cv = model.cost_volume(cam, proj)
        want_maps = model.disparity_maps(cam, proj)
    cam_u = cam.clone().requires_grad_(True)
    model(cam_u, proj).soft_disparity.mean().backward()
    cam_t = cam.clone().requires_grad_(True)
    model.trainable_disparity_maps(cam_t, proj).soft_disparity.mean(
        ).backward()

    for dd, ss in mesh_shapes(n):
        if B % dd or H % ss or H // ss < cfg.pad:
            continue
        mesh = make_mesh(MeshConfig(dd, ss), device.type)
        name = f"{dd}x{ss}"
        if mesh.get_coordinate() is None:
            step_seconds(lambda: None, device, 5, 1)
            continue
        c_s, p_s = shard_batch((cam, proj), mesh)
        with torch.no_grad():
            out = model.sharded_apply(c_s, p_s, mesh)
            check(torch.equal(out.cost_volume.full_tensor(), want_cv),
                  f"mesh {name}: sharded volume (K1) bit-equal")
            maps = sharded_disparity_maps(c_s, p_s, cfg, mesh)
            check(all(torch.equal(m.full_tensor(), w)
                      for m, w in zip(maps, want_maps)),
                  f"mesh {name}: sharded fused maps (K3) bit-equal")
        for trainable, want in ((False, cam_u.grad), (True, cam_t.grad)):
            c = shard_batch(cam, mesh).requires_grad_(True)
            if trainable:
                soft = sharded_disparity_maps(c, p_s, cfg, mesh,
                                              trainable=True).soft_disparity
            else:
                soft = model.sharded_apply(c, p_s, mesh).soft_disparity
            soft.mean().backward()
            ok, err, rel = _close(c.grad.full_tensor(), want, 1e-3, 1e-6,
                                  1e-4)
            check(ok, f"mesh {name}: camera gradient through "
                  f"{'K3w + K4' if trainable else 'K1 + K2'}",
                  f"max_abs {err:.3e} norm_rel {rel:.3e}")
        if ss > 1:
            block = c_s.to_local()
            ext = halo_exchange(block, cfg.pad, mesh.get_group(1), axis=1)
            r = mesh.get_local_rank(1)
            h = H // ss
            b = mesh.get_local_rank(0) * (B // dd)
            rows = F.pad(cam, (0, 0, cfg.pad, cfg.pad))[
                b:b + B // dd, r * h:r * h + h + 2 * cfg.pad]
            check(torch.equal(ext, rows),
                  f"mesh {name}: halo_exchange delivers the global rows")
        with torch.no_grad():
            sec = step_seconds(
                lambda: sharded_disparity_maps(c_s, p_s, cfg, mesh),
                device, 5, 1)
        times[name] = 1e3 * sec

    Dp = args.stage_disparities
    cfg_p = StereoConfig(kernel_size=k, num_disparities=Dp)
    with torch.no_grad():
        # K3 on a card, its plain version on CPU tensors.
        full = stereo_pipeline_cuda(cam, proj, Dp, k, cfg.epsilon,
                                    cfg.softargmax_beta, cfg.cost_threshold)
        S = 2
        while S <= n:
            if (Dp + 1) % S == 0:
                mesh = stage_mesh(S, device.type)
                if mesh.get_coordinate() is not None:
                    got = pipelined_video_maps(cam, proj, cfg_p, mesh)
                    hard = all(torch.equal(getattr(got, f),
                                           getattr(full, f))
                               for f in ("disparity", "mask"))
                    soft = [_close(getattr(got, f), getattr(full, f), 1e-4,
                                   1e-5)
                            for f in ("soft_disparity", "confidence")]
                    check(hard and all(s[0] for s in soft),
                          f"pipeline S={S}: full-range K3 maps",
                          f"soft max_abs {soft[0][1]:.3e}, confidence "
                          f"max_abs {soft[1][1]:.3e}")
            S *= 2
    # A check passes when every rank that ran it passed it.
    gathered: List[list] = [None] * n
    dist.all_gather_object(gathered, checks)
    merged = {}
    for rank_checks in gathered:
        for ok, what, detail in rank_checks:
            prev = merged.get(what, (True, detail))
            merged[what] = (prev[0] and ok, detail if not ok else prev[1])
    checks = [(ok, what, detail) for what, (ok, detail) in merged.items()]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"rank": world_rank(), "ranks": n, "device": name,
            "backend": dist.get_backend(),
            "shape": [B, H, W, D, k], "checks": checks,
            "sharded_maps_ms": times,
            "ok": all(c[0] for c in checks)}


def report(summary: dict) -> int:
    for ok, what, detail in summary["checks"]:
        print(f"{'PASS' if ok else 'FAIL'} {what}"
              + (f" ({detail})" if detail else ""))
    for mesh, ms in summary["sharded_maps_ms"].items():
        print(f"time: sharded_disparity_maps at mesh {mesh}: {ms:.4f} ms "
              f"(host clock, barrier to barrier, median of 5; "
              f"{summary['device']})")
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("checks", "rank")}))
    return 0 if summary["ok"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--disparities", "-D", type=int, default=192)
    ap.add_argument("--stage-disparities", type=int, default=191,
                    help="D of the stage pipeline (D + 1 divides by S)")
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --device cpu: spawn this many gloo ranks")
    args = ap.parse_args(argv)
    summary = launch(run, args, args.ranks, args.device)
    if summary["rank"] == 0:
        return report(summary)
    return 0 if summary["ok"] else 1

if __name__ == "__main__":
    sys.exit(main())
