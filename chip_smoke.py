#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port's serving path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX.  Phases, each printing its lines:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build: both kernels from ``custereomatching_tpu_torch/csrc``;
3. K1 (banded volume) against its plain PyTorch version on the card;
4. K3 (fused pipeline) against its plain version, both head branches;
5. the main path, with every launch counter reset just before it:
   ``entry()``, a batched ``StereoMatcher`` forward and a
   ``StereoEngine`` serving 8 KITTI-size frames; the kernel counters must
   rise by the number of calls and the plain versions must not run;
6. device times of both kernels and both plain versions at KITTI size.

The last three lines are the kernel summary (JSON), the card's name and
power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; so does a machine without a
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from custereomatching_tpu_torch import StereoConfig, StereoEngine, StereoMatcher
from custereomatching_tpu_torch.data import make_stereo_pair
from custereomatching_tpu_torch.models import entry
from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import cost_volume_banded_cuda
from custereomatching_tpu_torch.ops.zncc import forward_banded
from custereomatching_tpu_torch.utils import benchmark, fence

EPS = 1e-8
THRESHOLD = 0.6
# (B, H, W, D, k): the JAX suite's kernel shapes, a batch, and KITTI.
SHAPES = [(1, 24, 150, 10, 5), (1, 17, 100, 3, 3), (1, 12, 260, 140, 7),
          (1, 9, 40, 0, 5), (2, 16, 48, 6, 5)]
KITTI = (375, 1242, 192, 15)
BUCKET = (384, 1280)
# Served frames: a slanted plane spanning most of the 0..192 band.
D_MIN, D_MAX = 4.0, 184.0
N_FRAMES = 8


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def uniform_pair(seed: int, B: int, H: int, W: int):
    rng = np.random.default_rng(seed)
    cam = rng.random((B, H, W), dtype=np.float32)
    proj = rng.random((B, H, W), dtype=np.float32)
    return torch.from_numpy(cam).cuda(), torch.from_numpy(proj).cuda()


def speckle_frames(n: int, seed: int):
    """``n`` KITTI-size synthetic pairs and their true disparity."""
    H, W, _, _ = KITTI
    pairs = [make_stereo_pair(H, W, d_min=D_MIN, d_max=D_MAX, seed=seed + i)
             for i in range(n)]
    return [np.stack(x) for x in zip(*pairs)]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_env() -> str:
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc '{nvcc.splitlines()[-1]}'")
    card = smi_line()
    print(f"env: card {card}; torch sees {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.kernels()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build: {line.strip()}")


def compare_volume(got, want, label: str) -> float:
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite K1 output")
    diff = (got - want).abs()
    bad = int((diff > 1e-5 + 1e-4 * want.abs()).sum())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if big.any() else 0.
    max_abs = float(diff.max())
    print(f"K1 {label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"outside rtol 1e-4/atol 1e-5: {bad}")
    require(bad == 0, f"K1 {label} within rtol 1e-4 / atol 1e-5")
    return max_abs


def phase_k1() -> float:
    err = 0.0
    for i, (B, H, W, D, k) in enumerate(SHAPES + [(2,) + KITTI]):
        cam, proj = uniform_pair(i, B, H, W)
        got = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        want = forward_banded(cam, proj, D, k, EPS)
        err = max(err, compare_volume(got, want,
                                      f"B={B} H={H} W={W} D={D} k={k}"))
        del got, want
    return err


def compare_maps(got, want, cost, threshold: float, exact: bool,
                 label: str) -> float:
    """K3 maps against the plain pipeline.  ``exact``: disparity and mask
    must match bit for bit.  Otherwise a mask may flip only within 1e-5 of
    the threshold (at most 1e-4 of the pixels) and a disparity may differ
    only where the mask flips or the top two costs lie within 1e-5."""
    torch.cuda.synchronize()
    for name in got._fields:
        require(bool(torch.isfinite(getattr(got, name)).all()),
                f"{label}: non-finite {name}")
    conf_err = (got.confidence - want.confidence).abs()
    require(bool((conf_err <= 1e-5 + 1e-5 * want.confidence.abs()).all()),
            f"{label}: confidence within rtol 1e-5 / atol 1e-5")
    flips = got.mask != want.mask
    same = ~flips
    soft_err = (got.soft_disparity - want.soft_disparity).abs()[same]
    require(bool((soft_err <= 1e-3 + 1e-3 * want.soft_disparity.abs()[same])
                 .all()), f"{label}: soft disparity within rtol/atol 1e-3")
    differ = got.disparity != want.disparity
    n_flip, n_differ = int(flips.sum()), int(differ.sum())
    if exact:
        require(n_flip == 0 and n_differ == 0,
                f"{label}: mask and disparity exact")
        n_tie = 0
    else:
        near = (want.confidence - threshold).abs() <= 1e-5
        require(n_flip <= 1e-4 * flips.numel(),
                f"{label}: mask flips {n_flip} within 1e-4 of the pixels")
        require(bool(near[flips].all()),
                f"{label}: every mask flip within 1e-5 of the threshold")
        top2 = torch.topk(cost, 2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= 1e-5
        unexplained = differ & ~flips & ~tie
        n_tie = int((differ & ~flips & tie).sum())
        require(not bool(unexplained.any()),
                f"{label}: {int(unexplained.sum())} disparity mismatches "
                f"without a mask flip or a top-two tie")
    print(f"K3 {label}: conf max_abs {float(conf_err.max()):.3e}, soft "
          f"max_abs {float(soft_err.max()) if soft_err.numel() else 0.:.3e},"
          f" mask flips {n_flip}, disparity mismatches {n_differ} "
          f"(top-two ties {n_tie})")
    return float(conf_err.max())


def phase_k3() -> float:
    err = 0.0
    cases = [(s, 50.0) for s in SHAPES] + [((1, 16, 100, 37, 7), 80.0)]
    for i, ((B, H, W, D, k), beta) in enumerate(cases):
        cam, proj = uniform_pair(100 + i, B, H, W)
        got = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
        want = stereo_pipeline_reference(cam, proj, D, k, EPS, beta,
                                         THRESHOLD)
        err = max(err, compare_maps(
            got, want, None, THRESHOLD, True,
            f"B={B} H={H} W={W} D={D} k={k} beta={beta}"))
    H, W, D, k = KITTI
    cams, projs, _ = speckle_frames(1, seed=7)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    got = stereo_pipeline_cuda(cam, proj, D, k, EPS, 50.0, THRESHOLD)
    want = stereo_pipeline_reference(cam, proj, D, k, EPS, 50.0, THRESHOLD)
    cost = forward_banded(cam, proj, D, k, EPS)
    err = max(err, compare_maps(got, want, cost, THRESHOLD, False,
                                f"speckle B=1 H={H} W={W} D={D} k={k} "
                                f"beta=50.0"))
    return err


def reset_counters() -> None:
    cost_volume_banded_cuda.launches = 0
    stereo_pipeline_cuda.launches = 0
    forward_banded.calls = 0
    stereo_pipeline_reference.calls = 0


def phase_main_path() -> dict:
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    batch = speckle_frames(2, seed=20)
    frames = speckle_frames(N_FRAMES, seed=40)
    engine = StereoEngine(cfg, buckets=[BUCKET], device="cuda")

    reset_counters()
    with torch.no_grad():
        forward, args = entry("cuda")
        soft = fence(forward(*args))
        out = fence(StereoMatcher(cfg)(torch.from_numpy(batch[0]).cuda(),
                                       torch.from_numpy(batch[1]).cuda()))
    engine.warmup()
    served, latency = [], []
    for cam, proj in zip(frames[0], frames[1]):
        t0 = time.perf_counter()
        served.append(engine.infer(cam, proj))
        latency.append(time.perf_counter() - t0)
    counts = {"k1": cost_volume_banded_cuda.launches,
              "k3": stereo_pipeline_cuda.launches,
              "plain_volume": forward_banded.calls,
              "plain_pipeline": stereo_pipeline_reference.calls}
    print(f"main path: counters {counts}")
    require(counts["k1"] == 2, "K1 launched once per volume call (2)")
    require(counts["k3"] == 1 + N_FRAMES,
            f"K3 launched once per warm-up and served frame "
            f"({1 + N_FRAMES})")
    require(counts["plain_volume"] == 0 and counts["plain_pipeline"] == 0,
            "plain versions unused on the main path")

    require(tuple(soft.shape) == (1, 96, 160)
            and bool(torch.isfinite(soft).all()), "entry() output")
    require(tuple(out.cost_volume.shape) == (2, H, W, D + 1)
            and bool(torch.isfinite(out.cost_volume).all())
            and bool(torch.isfinite(out.soft_disparity).all()),
            "StereoMatcher forward output")
    fwd_mask = out.mask.bool().cpu().numpy()
    fwd_epe = float(np.abs(out.soft_disparity.cpu().numpy()
                           - batch[2])[fwd_mask].mean())
    print(f"main path: entry() soft disparity {tuple(soft.shape)} finite; "
          f"forward [2, {H}, {W}] coverage {fwd_mask.mean():.4f} "
          f"EPE {fwd_epe:.4f} px")

    mask = np.stack([m.mask for m in served]).astype(bool)
    soft_d = np.stack([m.soft_disparity for m in served])
    require(soft_d.shape == (N_FRAMES, H, W) and np.isfinite(soft_d).all(),
            "served maps")
    coverage = float(mask.mean())
    epe = float(np.abs(soft_d - frames[2])[mask].mean())
    bad1 = float((np.abs(soft_d - frames[2])[mask] > 1.0).mean())
    print(f"main path: engine served {N_FRAMES} frames {H}x{W} in bucket "
          f"{BUCKET}: coverage {coverage:.4f}, EPE {epe:.4f} px, "
          f">1px {bad1:.4f} on confident pixels; host latency median "
          f"{1e3 * float(np.median(latency)):.3f} ms")
    require(coverage > 0.5 and epe < 1.0, "engine accuracy")

    # Zero-padding to the bucket is exact: same maps as the unpadded frame.
    direct = stereo_pipeline_cuda(torch.from_numpy(frames[0][:1]).cuda(),
                                  torch.from_numpy(frames[1][:1]).cuda(),
                                  D, k, cfg.epsilon, cfg.softargmax_beta,
                                  cfg.cost_threshold)
    for name in direct._fields:
        require(np.array_equal(getattr(direct, name)[0].cpu().numpy(),
                               getattr(served[0], name)),
                f"engine {name} equals the unpadded K3 output")
    print("main path: engine output equals unpadded K3 output bit for bit")
    return counts


def timed(label: str, fn, *args) -> float:
    ms = 1e3 * benchmark(fn, *args, warmup=2, iters=10, chain=3)["median_s"]
    print(f"time: {label} median {ms:.4f} ms")
    return ms


def phase_times(card: str) -> dict:
    H, W, D, k = KITTI
    cam, proj = uniform_pair(0, 1, H, W)
    cams, projs, _ = speckle_frames(1, seed=7)
    scam, sproj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    vol = (cam, proj, D, k, EPS)
    pipe = (scam, sproj, D, k, EPS, 50.0, THRESHOLD)
    times = {}
    with torch.no_grad():
        # Interleaved: plain, kernel, kernel, plain.
        for name, kernel, plain, args in (
                ("K1", cost_volume_banded_cuda, forward_banded, vol),
                ("K3", stereo_pipeline_cuda, stereo_pipeline_reference, pipe)):
            p1 = timed(f"{name} plain", plain, *args)
            k1 = timed(f"{name} kernel", kernel, *args)
            k2 = timed(f"{name} kernel", kernel, *args)
            p2 = timed(f"{name} plain", plain, *args)
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"time: {name} at KITTI {H}x{W} D={D} k={k}: kernel "
                  f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
                  f"({card})")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_env()
    phase_build()
    k1_err = phase_k1()
    k3_err = phase_k3()
    counts = phase_main_path()
    times = phase_times(card)

    kernels = [
        {"name": "zncc_banded_volume", "route": "cuda",
         "source": "custereomatching_tpu_torch/csrc/zncc_banded.cu",
         "replaces": "custereomatching_tpu/ops/pallas_zncc.py:156",
         "launches": counts["k1"], "max_abs_err": k1_err,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "fused_pipeline", "route": "cuda",
         "source": "custereomatching_tpu_torch/csrc/fused_pipeline.cu",
         "replaces": "custereomatching_tpu/ops/pallas_pipeline.py:120",
         "launches": counts["k3"], "max_abs_err": k3_err,
         "ms": times["K3"][0], "plain_ms": times["K3"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
