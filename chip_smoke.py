#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port: the serving path, the
training path, the all-pairs path and the projector-gradient path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX.  Phases, each printing its lines:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build: every kernel from ``custereomatching_tpu_torch/csrc``, one nvcc
   per source, in parallel;
3. K1 (banded volume) against its plain PyTorch version on the card;
4. K3 (fused pipeline) against its plain version, both head branches;
5. the serving path, with every launch counter reset just before it:
   ``entry()``, a batched ``StereoMatcher`` forward and a
   ``StereoEngine`` serving 8 KITTI-size frames; the kernel counters must
   rise by the number of calls and the plain versions must not run;
6. K2 (camera VJP) against the plain closed form, the same random
   cotangent fed to both, at entry()'s shape and at KITTI too;
7. K3w (training forward): its volume against the plain volume, its four
   maps bit-equal to K3's, its argmax, s and t against the plain head;
8. K4 (trainable backward) against its plain twin on the same residuals,
   and the whole trainable pipeline (K3w + K4) against its plain twin,
   both head branches and KITTI speckle;
9. the training path, with every launch counter reset just before it:
   ``entry()``'s soft disparity backpropagated to the camera (K1 + K2),
   then ``optimize_camera`` for 5 Adam steps at KITTI size (K3w + K4); the
   kernel counters must rise by the number of calls, the plain versions
   must not run, and the losses must be finite and falling; then, outside
   the counted run, entry()'s camera gradient against the plain VJP fed
   the same head cotangent;
10. K8 (all-pairs volume) against its plain version at the JAX suite's
    shapes, a batch, the 330x422 verify shape and 375x1242 (the wide y
    extent);
11. K7 (projector VJP) against the plain closed form on the same cost and
    cotangent, at the JAX suite's shapes, a batch and KITTI;
12. the all-pairs path, with every launch counter reset just before it:
    the default ``StereoMatcher`` (all-pairs) forward, plain head and
    backward of a mean soft-disparity loss at 330x422, k=15; K8 must run
    once and the plain forward never, and the camera gradient must match
    the plain node's (plain volume and plain VJP);
13. the projector-gradient path, counters reset: the banded KITTI model
    with ``grad_projector=True``, forward, plain head and backward; K1, K2
    and K7 must run once each, and both gradients must match the plain
    closed forms fed the same head cotangent;
14. device times of every kernel and its plain version: K8 at 330x422,
    the others at KITTI size.

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
from custereomatching_tpu_torch.models import (
    adam,
    entry,
    init_state,
    make_train_step,
    optimize_camera,
)
from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    fused_pipeline_bwd_cuda,
    fused_pipeline_bwd_reference,
    fused_pipeline_train_cuda,
    fused_pipeline_train_reference,
    head_residuals,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    camera_grad_banded_cuda,
    cost_volume_banded_cuda,
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.zncc import (
    box2d,
    camera_grad_allpairs,
    camera_grad_banded,
    forward_allpairs,
    forward_banded,
    projector_grad_banded,
)
from custereomatching_tpu_torch.utils import benchmark, fence

EPS = 1e-8
THRESHOLD = 0.6
# (B, H, W, D, k): the JAX suite's kernel shapes, a batch, and KITTI.
SHAPES = [(1, 24, 150, 10, 5), (1, 17, 100, 3, 3), (1, 12, 260, 140, 7),
          (1, 9, 40, 0, 5), (2, 16, 48, 6, 5)]
KITTI = (375, 1242, 192, 15)
# entry()'s shape (B, H, W, D, k): where the training path runs K2.
ENTRY = (1, 96, 160, 64, 15)
BUCKET = (384, 1280)
# Served frames: a slanted plane spanning most of the 0..192 band.
D_MIN, D_MAX = 4.0, 184.0
N_FRAMES = 8
# Training path: Adam steps of optimize_camera from a camera with this much
# Gaussian noise; then more steps, timed on the host clock.
TRAIN_STEPS, TRAIN_LR, TRAIN_NOISE, TIMED_STEPS = 5, 1e-3, 0.05, 10
# All-pairs (B, H, W, k): the JAX suite's kernel shapes
# (tests/test_pallas_allpairs.py:28-31) and a batch; then the reference's
# verify shape, where the all-pairs path runs, and KITTI's width.
AP_SHAPES = [(1, 24, 60, 5), (1, 16, 150, 15), (1, 13, 40, 7),
             (1, 9, 129, 3), (2, 16, 48, 5)]
VERIFY = (330, 422, 15)
AP_WIDE = (1, 375, 1242, 15)
# K7 (B, H, W, D, k): the JAX suite's shapes (tests/test_pallas_bwd.py:
# 277-281) and a batch; KITTI is added in the phase.
K7_SHAPES = [(1, 16, 24, 5, 3), (1, 24, 150, 10, 5), (1, 40, 96, 12, 15),
             (2, 16, 48, 6, 5)]
# Gradient checks: the JAX suite's elementwise tolerance
# (tests/test_pallas_bwd.py:89) at the small shapes, and a bound on
# ||got - want|| / ||want|| everywhere (KITTI included).
GRAD_RTOL, GRAD_ATOL, GRAD_NORM_REL = 1e-3, 1e-6, 1e-4


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


def compare_volume(got, want, label: str, kernel: str = "K1") -> float:
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()),
            f"{label}: non-finite {kernel} output")
    diff = (got - want).abs()
    bad = int((diff > 1e-5 + 1e-4 * want.abs()).sum())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if big.any() else 0.
    max_abs = float(diff.max())
    print(f"{kernel} {label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"outside rtol 1e-4/atol 1e-5: {bad}")
    require(bad == 0, f"{kernel} {label} within rtol 1e-4 / atol 1e-5")
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


KERNEL_COUNTERS = {
    "k1": cost_volume_banded_cuda, "k3": stereo_pipeline_cuda,
    "k2": camera_grad_banded_cuda, "k3w": fused_pipeline_train_cuda,
    "k4": fused_pipeline_bwd_cuda, "k8": cost_volume_allpairs_cuda,
    "k7": projector_grad_banded_cuda}
# Plain twins of kernels: no main path may call them.
PLAIN_COUNTERS = {
    "plain_volume": forward_banded,
    "plain_pipeline": stereo_pipeline_reference,
    "plain_vjp": camera_grad_banded,
    "plain_train_fwd": fused_pipeline_train_reference,
    "plain_train_bwd": fused_pipeline_bwd_reference,
    "plain_trainable": stereo_pipeline_trainable_reference,
    "plain_allpairs": forward_allpairs,
    "plain_proj_vjp": projector_grad_banded}
# The all-pairs camera VJP has no kernel in either package (the JAX
# package leaves it to XLA): it is the all-pairs path's own backward.
PATH_PLAIN_COUNTERS = {"allpairs_vjp": camera_grad_allpairs}


def reset_counters() -> None:
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0
    for fn in (*PLAIN_COUNTERS.values(), *PATH_PLAIN_COUNTERS.values()):
        fn.calls = 0


def read_counters() -> dict:
    counts = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
    counts.update({name: fn.calls for name, fn in PLAIN_COUNTERS.items()})
    counts.update({name: fn.calls
                   for name, fn in PATH_PLAIN_COUNTERS.items()})
    return counts


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
    counts = read_counters()
    print(f"main path: counters {counts}")
    require(counts["k1"] == 2, "K1 launched once per volume call (2)")
    require(counts["k3"] == 1 + N_FRAMES,
            f"K3 launched once per warm-up and served frame "
            f"({1 + N_FRAMES})")
    require(not any(counts[name] for name in PLAIN_COUNTERS),
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


def top2_ties(cost_hwd: torch.Tensor) -> torch.Tensor:
    """Pixels whose two largest costs lie within 1e-5 ([B, H, W] bool)."""
    if cost_hwd.shape[-1] < 2:
        return torch.zeros(cost_hwd.shape[:-1], dtype=torch.bool,
                           device=cost_hwd.device)
    top2 = torch.topk(cost_hwd, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= 1e-5


def compare_grad(got, want, label: str, elementwise: bool,
                 keep=None) -> float:
    """A camera gradient against its plain twin over the pixels in
    ``keep``: ||got - want|| / ||want|| <= GRAD_NORM_REL always, and with
    ``elementwise`` every pixel within rtol GRAD_RTOL / atol GRAD_ATOL.
    Prints max abs, max rel (over |want| > 1e-3 max |want|), the norm
    ratio and GRAD_ATOL / max |want| (how loose the atol is at this
    gradient's scale); returns max abs."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite gradient")
    if keep is not None:
        got, want = got[keep], want[keep]
    diff = (got - want).abs()
    scale = want.abs()
    big = scale > 1e-3 * scale.max()
    max_abs = float(diff.max())
    max_rel = float((diff[big] / scale[big]).max()) if big.any() else 0.
    norm_rel = float(diff.norm() / want.norm())
    bad = int((diff > GRAD_ATOL + GRAD_RTOL * scale).sum())
    print(f"{label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"norm_rel {norm_rel:.3e} outside rtol {GRAD_RTOL}/atol "
          f"{GRAD_ATOL}: {bad} of {diff.numel()}; atol/max|want| "
          f"{GRAD_ATOL / float(scale.max()):.3e}")
    require(norm_rel <= GRAD_NORM_REL,
            f"{label}: norm-relative error within {GRAD_NORM_REL}")
    if elementwise:
        require(bad == 0, f"{label}: within rtol {GRAD_RTOL} / atol "
                          f"{GRAD_ATOL}")
    return max_abs


def phase_k2() -> float:
    err = 0.0
    for i, (B, H, W, D, k) in enumerate(SHAPES + [ENTRY, (1,) + KITTI]):
        cam, proj = uniform_pair(200 + i, B, H, W)
        # A random cotangent at the scale of a mean loss over the frame's
        # pixels (1 / (H W)), the regime of the JAX suite's tolerance.
        g = torch.randn((B, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        got = camera_grad_banded_cuda(cam, proj, cost.permute(0, 3, 1, 2), g,
                                      D, k, EPS)
        want = camera_grad_banded(cam, proj, g.permute(0, 2, 3, 1), D, k,
                                  EPS)
        kitti = (H, W, D, k) == KITTI
        err = max(err, compare_grad(
            got, want, f"K2 B={B} H={H} W={W} D={D} k={k}",
            elementwise=not kitti))
        del g, cost, got, want
    return err


def train_cases():
    """(label, camera, projector, D, k, beta): the small shapes, the
    rescaled head, and KITTI speckle."""
    cases = []
    for i, ((B, H, W, D, k), beta) in enumerate(
            [(s, 50.0) for s in SHAPES] + [((1, 16, 100, 37, 7), 80.0)]):
        cam, proj = uniform_pair(300 + i, B, H, W)
        cases.append((f"B={B} H={H} W={W} D={D} k={k} beta={beta}", cam,
                      proj, D, k, beta))
    H, W, D, k = KITTI
    cams, projs, _ = speckle_frames(1, seed=7)
    cases.append((f"speckle B=1 H={H} W={W} D={D} k={k} beta=50.0",
                  torch.from_numpy(cams).cuda(),
                  torch.from_numpy(projs).cuda(), D, k, 50.0))
    return cases


def phase_k3w() -> float:
    err = 0.0
    for label, cam, proj, D, k, beta in train_cases():
        maps, res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                              THRESHOLD)
        serving = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
        want = forward_banded(cam, proj, D, k, EPS)
        err = max(err, compare_volume(res.volume.permute(0, 2, 3, 1), want,
                                      f"volume {label}", kernel="K3w"))
        for name in maps._fields:
            require(torch.equal(getattr(maps, name),
                                getattr(serving, name)),
                    f"K3w {label}: {name} bit-equal to K3's")
        am, _, s, t = head_residuals(want, D, beta)
        tie = top2_ties(want)
        am_differ = res.am != am
        require(not bool((am_differ & ~tie).any()),
                f"K3w {label}: argmax differs only at top-two ties")
        # s and t do not depend on which index is the argmax, so every
        # pixel is compared, ties included.  s within rtol 1e-3; t within
        # rtol 1e-3 plus atol 1e-3 s, i.e. |dt| <= 1e-3 (t + s).  |dt| / s
        # alone cannot hold: t = sum_d d w_d carries the planes' rounding,
        # amplified by beta in w_d, at the scale of t / s (the soft
        # disparity, up to D); printed for the record.
        dt = (res.t - t).abs()
        s_max = float(((res.s - s).abs() / s).max())
        t_max = float((dt / (t + s)).max())
        ts_max = float((dt / s).max())
        require(s_max <= 1e-3 and t_max <= 1e-3,
                f"K3w {label}: s within rtol 1e-3, t within 1e-3 (t + s)")
        print(f"K3w {label}: maps bit-equal to K3; argmax mismatches "
              f"{int(am_differ.sum())} (top-two ties {int(tie.sum())}); "
              f"|ds|/s max {s_max:.3e}, |dt|/(t+s) max {t_max:.3e}, "
              f"|dt|/s max {ts_max:.3e}")
        del maps, res, serving, want
    return err


def cotangents(seed: int, B: int, H: int, W: int):
    """Random soft and confidence cotangents at the scale of a mean
    loss's (1 / (H W))."""
    gen = torch.Generator("cuda").manual_seed(seed)
    scale = 1.0 / (H * W)
    return (torch.randn((B, H, W), device="cuda", generator=gen) * scale,
            torch.randn((B, H, W), device="cuda", generator=gen) * scale)


def phase_k4() -> float:
    err = 0.0
    for i, (label, cam, proj, D, k, beta) in enumerate(train_cases()):
        B, H, W = cam.shape
        kitti = (H, W, D, k) == KITTI
        gs, gc = cotangents(400 + i, B, H, W)
        # K4 and its plain twin on the same residuals (K3w's).
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                        THRESHOLD)[1]
        got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS,
                                      beta)
        want = fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D, k,
                                            EPS, beta)
        err = max(err, compare_grad(got, want, f"K4 {label}",
                                    elementwise=not kitti))
        del res, got, want

        # The whole trainable pipeline against its plain twin: the two
        # forwards may disagree on the argmax only at top-two ties and on
        # the mask only within 1e-5 of the threshold; the gradient is
        # compared outside the k x k neighbourhoods of such pixels.
        grads, outs = [], []
        for fn in (stereo_pipeline_trainable,
                   stereo_pipeline_trainable_reference):
            c = cam.clone().requires_grad_(True)
            out = fn(c, proj, D, k, EPS, beta, THRESHOLD)
            loss = ((out.soft_disparity * gs).sum()
                    + (out.confidence * gc).sum())
            grads.append(torch.autograd.grad(loss, c)[0])
            outs.append(tuple(m.detach() for m in out))
        (_, _, mask_k, _), (_, _, mask_p, conf_p) = outs
        cost = forward_banded(cam, proj, D, k, EPS)
        tie = top2_ties(cost)
        am_k = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                         THRESHOLD)[1].am
        am_p = head_residuals(cost, D, beta)[0]
        flips = mask_k != mask_p
        differ = am_k != am_p
        require(bool(((conf_p - THRESHOLD).abs() <= 1e-5)[flips].all()),
                f"K3w+K4 {label}: every mask flip within 1e-5 of the "
                f"threshold")
        require(not bool((differ & ~tie).any()),
                f"K3w+K4 {label}: argmax differs only at top-two ties")
        odd = (flips | differ).to(cam.dtype)
        keep = box2d(odd, k, dim=1) == 0
        print(f"K3w+K4 {label}: argmax mismatches {int(differ.sum())}, mask "
              f"flips {int(flips.sum())}; gradient compared on "
              f"{int(keep.sum())} of {keep.numel()} pixels")
        compare_grad(grads[0], grads[1], f"K3w+K4 {label}",
                     elementwise=not kitti, keep=keep)
        del grads, outs, cost
    return err


def phase_train_path() -> dict:
    H, W, D, k = KITTI
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D))
    cams, projs, _ = speckle_frames(1, seed=60)
    true_cam = torch.from_numpy(cams).cuda()
    proj = torch.from_numpy(projs).cuda()
    with torch.no_grad():
        target = model.disparity_maps(true_cam, proj).soft_disparity
    noise = np.random.default_rng(61).standard_normal(cams.shape)
    camera0 = true_cam + torch.from_numpy(
        (TRAIN_NOISE * noise).astype(np.float32)).cuda()
    forward, (cam_e, proj_e) = entry("cuda")
    require(tuple(cam_e.shape) == ENTRY[:3], f"entry() inputs {ENTRY[:3]}")
    cam_e = cam_e.clone().requires_grad_(True)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    # A mean loss, as disparity_loss is.
    forward(cam_e, proj_e).mean().backward()
    camera, losses = optimize_camera(model, camera0, proj, target,
                                     learning_rate=TRAIN_LR,
                                     num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = read_counters()
    print(f"train path: counters {counts}")
    require(counts["k1"] == 1 and counts["k2"] == 1,
            "entry() backward: K1 and K2 launched once each")
    require(counts["k3w"] == TRAIN_STEPS and counts["k4"] == TRAIN_STEPS,
            f"K3w and K4 launched once per step ({TRAIN_STEPS})")
    require(counts["k3"] == 0, "K3 (serving) unused on the training path")
    require(not any(counts[name] for name in PLAIN_COUNTERS),
            "plain versions unused on the training path")
    require(cam_e.grad is not None
            and tuple(cam_e.grad.shape) == ENTRY[:3]
            and bool(torch.isfinite(cam_e.grad).all()),
            "entry() camera gradient")

    # K2 as the path ran it, outside the counted window: entry()'s camera
    # gradient against the plain closed-form VJP fed the same cotangent,
    # the plain head's gradient on K1's volume.
    _, _, _, De, ke = ENTRY
    cfg_e = StereoConfig(kernel_size=ke, num_disparities=De)
    cam_d = cam_e.detach()
    cost = cost_volume_banded_cuda(cam_d, proj_e, De, ke, cfg_e.epsilon)
    cost = cost.detach().requires_grad_(True)
    soft = StereoMatcher(cfg_e).disparity(cost).soft_disparity
    (g,) = torch.autograd.grad(soft.mean(), cost)
    want = camera_grad_banded(cam_d, proj_e, g, De, ke, cfg_e.epsilon)
    compare_grad(cam_e.grad, want, "train path: entry() camera gradient "
                 "against the plain VJP on its head cotangent",
                 elementwise=True)
    del cost, soft, g, want
    losses = losses.cpu().tolist()
    print(f"train path: entry() camera gradient {tuple(cam_e.grad.shape)} "
          f"finite, norm {float(cam_e.grad.norm()):.6e}; optimize_camera "
          f"{TRAIN_STEPS} steps at {H}x{W} D={D} k={k} lr={TRAIN_LR}: "
          f"losses {losses}")
    require(all(np.isfinite(losses)), "every loss finite")
    require(losses[-1] < losses[0], "the last loss below the first")
    require(bool(torch.isfinite(camera).all()), "optimised camera finite")

    # Host-clock time of a whole step (K3w, loss, K4, Adam), synchronised.
    state = init_state(camera0, adam(TRAIN_LR))
    step = make_train_step(model)
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, proj, target)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(times[1:]))
    print(f"train path: step host-clock median {step_ms:.3f} ms over "
          f"{TIMED_STEPS - 1} steps (first dropped); peak device memory "
          f"of the path {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts["step_ms"] = step_ms
    return counts


def phase_k8() -> float:
    err = 0.0
    for i, (B, H, W, k) in enumerate(AP_SHAPES + [(1,) + VERIFY, AP_WIDE]):
        cam, proj = uniform_pair(500 + i, B, H, W)
        got = cost_volume_allpairs_cuda(cam, proj, k, EPS)
        want = forward_allpairs(cam, proj, k, EPS)
        require(tuple(got.shape) == (B, H, W, W), f"K8 shape {(B, H, W, W)}")
        err = max(err, compare_volume(got, want, f"B={B} H={H} W={W} k={k}",
                                      kernel="K8"))
        del got, want
        torch.cuda.empty_cache()
    return err


def phase_k7() -> float:
    err = 0.0
    for i, (B, H, W, D, k) in enumerate(K7_SHAPES + [(1,) + KITTI]):
        cam, proj = uniform_pair(600 + i, B, H, W)
        # A random cotangent at a mean loss's scale, as phase_k2's.
        g = torch.randn((B, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        got = projector_grad_banded_cuda(cam, proj, cost.permute(0, 3, 1, 2),
                                         g, D, k, EPS)
        want = projector_grad_banded(cam, proj, cost, g.permute(0, 2, 3, 1),
                                     D, k, EPS)
        kitti = (H, W, D, k) == KITTI
        err = max(err, compare_grad(
            got, want, f"K7 B={B} H={H} W={W} D={D} k={k}",
            elementwise=not kitti))
        del g, cost, got, want
    return err


def phase_allpairs_path() -> dict:
    H, W, k = VERIFY
    model = StereoMatcher(StereoConfig(kernel_size=k, backend="cuda"))
    require(model.config.num_disparities is None,
            "the default config is all-pairs")
    cam_np, proj_np, truth = make_stereo_pair(H, W, d_min=2.0, d_max=12.0,
                                              noise=0.01, seed=0)
    cam = torch.from_numpy(cam_np[None]).cuda().requires_grad_(True)
    proj = torch.from_numpy(proj_np[None]).cuda()
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    out = model(cam, proj)
    out.soft_disparity.mean().backward()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counters()
    print(f"all-pairs path: counters {counts}")
    require(counts["k8"] == 1, "K8 launched once")
    require(counts["allpairs_vjp"] == 1, "the all-pairs VJP ran once")
    require(not any(counts[name] for name in PLAIN_COUNTERS),
            "plain twins unused on the all-pairs path")
    require(tuple(out.cost_volume.shape) == (1, H, W, W)
            and bool(torch.isfinite(out.cost_volume).all())
            and bool(torch.isfinite(out.soft_disparity).all()),
            "all-pairs forward output")
    require(cam.grad is not None and tuple(cam.grad.shape) == (1, H, W),
            "all-pairs camera gradient")
    mask = out.mask[0].bool().cpu().numpy()
    soft = out.soft_disparity[0].detach().cpu().numpy()
    coverage = float(mask.mean())
    epe = float(np.abs(soft - truth)[mask].mean())
    print(f"all-pairs path: {H}x{W} k={k} forward + head + backward "
          f"{step_ms:.3f} ms host clock (first call); coverage "
          f"{coverage:.4f}, EPE {epe:.4f} px on confident pixels; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    require(coverage > 0.5 and epe < 1.0, "all-pairs accuracy")
    del out

    # The plain node (plain volume, plain VJP) on the same inputs, outside
    # the counted run.
    cam_p = cam.detach().clone().requires_grad_(True)
    plain = StereoMatcher(StereoConfig(kernel_size=k, backend="torch"))
    plain(cam_p, proj).soft_disparity.mean().backward()
    compare_grad(cam.grad, cam_p.grad, f"all-pairs path: camera gradient "
                 f"against the plain node at {H}x{W} k={k}",
                 elementwise=True)
    counts["step_ms"] = step_ms
    return counts


def phase_grad_projector_path() -> dict:
    H, W, D, k = KITTI
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D,
                                       grad_projector=True))
    cams, projs, _ = speckle_frames(1, seed=80)
    cam = torch.from_numpy(cams).cuda().requires_grad_(True)
    proj = torch.from_numpy(projs).cuda().requires_grad_(True)
    torch.cuda.synchronize()

    reset_counters()
    model(cam, proj).soft_disparity.mean().backward()
    torch.cuda.synchronize()
    counts = read_counters()
    print(f"grad_projector path: counters {counts}")
    require(counts["k1"] == 1 and counts["k2"] == 1 and counts["k7"] == 1,
            "K1, K2 and K7 launched once each")
    require(not any(counts[name] for name in PLAIN_COUNTERS),
            "plain twins unused on the grad_projector path")
    for name, grad in (("camera", cam.grad), ("projector", proj.grad)):
        require(grad is not None and tuple(grad.shape) == (1, H, W)
                and bool(torch.isfinite(grad).all()),
                f"grad_projector path: {name} gradient")

    # Both gradients against the plain closed forms fed the same head
    # cotangent, the plain head's gradient on K1's volume.
    cam_d, proj_d = cam.detach(), proj.detach()
    cost = cost_volume_banded_cuda(cam_d, proj_d, D, k, EPS)
    cost = cost.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(model.disparity(cost).soft_disparity.mean(),
                               cost)
    want_c = camera_grad_banded(cam_d, proj_d, g, D, k, EPS)
    want_p = projector_grad_banded(cam_d, proj_d, cost.detach(), g, D, k,
                                   EPS)
    compare_grad(cam.grad, want_c, "grad_projector path: camera gradient "
                 "against the plain VJP on its head cotangent",
                 elementwise=False)
    compare_grad(proj.grad, want_p, "grad_projector path: projector "
                 "gradient against the plain VJP on its head cotangent",
                 elementwise=False)
    del cost, g, want_c, want_p

    # Each backward kernel runs only for an input that needs its gradient.
    B, He, We, De, ke = ENTRY
    cam_e, proj_e = uniform_pair(81, B, He, We)
    proj_e.requires_grad_(True)
    small = StereoMatcher(StereoConfig(kernel_size=ke, num_disparities=De,
                                       grad_projector=True))
    before = (camera_grad_banded_cuda.launches,
              projector_grad_banded_cuda.launches)
    small(cam_e, proj_e).soft_disparity.mean().backward()
    after = (camera_grad_banded_cuda.launches,
             projector_grad_banded_cuda.launches)
    require(after == (before[0], before[1] + 1),
            "projector-only gradient: K7 launched, K2 not")
    print("grad_projector path: a projector-only gradient launches K7 and "
          "not K2")
    return counts


def timed(label: str, fn, *args) -> float:
    ms = 1e3 * benchmark(fn, *args, warmup=2, iters=10, chain=3)["median_s"]
    print(f"time: {label} median {ms:.4f} ms")
    return ms


def interleaved(name: str, kernel, plain, kargs, pargs, where: str,
                card: str):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    with torch.no_grad():
        p1 = timed(f"{name} plain", plain, *pargs)
        k1 = timed(f"{name} kernel", kernel, *kargs)
        k2 = timed(f"{name} kernel", kernel, *kargs)
        p2 = timed(f"{name} plain", plain, *pargs)
    ms = ((k1 + k2) / 2, (p1 + p2) / 2)
    print(f"time: {name} at {where}: kernel {ms[0]:.4f} ms, plain "
          f"{ms[1]:.4f} ms ({card})")
    return ms


def phase_times(card: str) -> dict:
    # K8 at the all-pairs path's shape.
    Hv, Wv, kv = VERIFY
    acam, aproj = uniform_pair(1, 1, Hv, Wv)
    ap = (acam, aproj, kv, EPS)
    times = {"K8": interleaved("K8", cost_volume_allpairs_cuda,
                               forward_allpairs, ap, ap,
                               f"{Hv}x{Wv} k={kv}", card)}
    del acam, aproj, ap
    torch.cuda.empty_cache()

    H, W, D, k = KITTI
    cam, proj = uniform_pair(0, 1, H, W)
    cams, projs, _ = speckle_frames(1, seed=7)
    scam, sproj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    vol = (cam, proj, D, k, EPS)
    pipe = (scam, sproj, D, k, EPS, 50.0, THRESHOLD)
    with torch.no_grad():
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        g = torch.randn((1, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        res = fused_pipeline_train_cuda(*pipe)[1]
    gs, gc = cotangents(1, 1, H, W)
    k2_args = (cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS)
    plain_vjp = (cam, proj, g.permute(0, 2, 3, 1), D, k, EPS)
    bwd = (scam, sproj, res, gs, gc, D, k, EPS, 50.0)
    cases = (
        ("K1", cost_volume_banded_cuda, forward_banded, vol, vol),
        ("K3", stereo_pipeline_cuda, stereo_pipeline_reference, pipe, pipe),
        ("K2", camera_grad_banded_cuda, camera_grad_banded, k2_args,
         plain_vjp),
        ("K7", projector_grad_banded_cuda, projector_grad_banded, k2_args,
         (cam, proj, cost) + plain_vjp[2:]),
        ("K3w", fused_pipeline_train_cuda, fused_pipeline_train_reference,
         pipe, pipe),
        ("K4", fused_pipeline_bwd_cuda, fused_pipeline_bwd_reference, bwd,
         bwd),
    )
    for name, kernel, plain, kargs, pargs in cases:
        times[name] = interleaved(name, kernel, plain, kargs, pargs,
                                  f"KITTI {H}x{W} D={D} k={k}", card)
    return times


KERNELS = (
    # name, key, source, replaces, path whose counters give its launches
    ("zncc_banded_volume", "K1", "custereomatching_tpu_torch/csrc/"
     "zncc_banded.cu", "custereomatching_tpu/ops/pallas_zncc.py:156",
     "serve"),
    ("fused_pipeline", "K3", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline.cu", "custereomatching_tpu/ops/pallas_pipeline.py:120",
     "serve"),
    ("zncc_banded_camera_vjp", "K2", "custereomatching_tpu_torch/csrc/"
     "zncc_banded_bwd.cu",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:54", "train"),
    ("fused_pipeline_train", "K3w", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline.cu", "custereomatching_tpu/ops/pallas_pipeline.py:120",
     "train"),
    ("fused_pipeline_bwd", "K4", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline_bwd.cu",
     "custereomatching_tpu/ops/pallas_pipeline.py:803", "train"),
    ("zncc_allpairs_volume", "K8", "custereomatching_tpu_torch/csrc/"
     "zncc_allpairs.cu", "custereomatching_tpu/ops/pallas_allpairs.py:60",
     "allpairs"),
    ("zncc_banded_projector_vjp", "K7", "custereomatching_tpu_torch/csrc/"
     "zncc_banded_proj_bwd.cu",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:607", "grad_projector"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_env()
    phase_build()
    errs = {"K1": phase_k1(), "K3": phase_k3()}
    counts = {"serve": phase_main_path()}
    errs["K2"] = phase_k2()
    errs["K3w"] = phase_k3w()
    errs["K4"] = phase_k4()
    counts["train"] = phase_train_path()
    errs["K8"] = phase_k8()
    errs["K7"] = phase_k7()
    counts["allpairs"] = phase_allpairs_path()
    counts["grad_projector"] = phase_grad_projector_path()
    times = phase_times(card)

    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[path][key.lower()],
         "max_abs_err": errs[key], "ms": times[key][0],
         "plain_ms": times[key][1]}
        for name, key, source, replaces, path in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
