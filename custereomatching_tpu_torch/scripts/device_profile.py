"""Where the time of the port's steps goes on one CUDA card.

    python -m custereomatching_tpu_torch.scripts.device_profile MODE...

Every mode runs at KITTI size (375x1242, D=192, k=15, B=1) on a synthetic
speckle frame and prints its lines, then one JSON object:

* ``train``: the fused train step (``make_train_step``: K3w, loss, K4,
  Adam).  The host-clock median of unprofiled steps; then as many steps
  again under ``torch.profiler``, in the same process and loop (each
  step synchronised): the device time per step of each kernel, the busy
  time (the union of the kernel, copy and memset intervals), the
  window's host-clock wall and its idle share ``1 - busy / wall``.  The
  profiler adds host work, so that share bounds the unprofiled run's
  from above; ``1 - busy / step`` against the unprofiled step is printed
  as an estimate (negative where the profiled kernels ran longer).
* ``free``: the volume-free train step (``stereo_pipeline_trainable``
  with ``save_volume=False``: K3m, the soft-disparity MSE, K5, Adam),
  profiled the same way.
* ``volume``: the volume path's step (``StereoMatcher.__call__``, the
  soft-disparity MSE, its backward through the head, K8h and K8hb, and
  K2),
  profiled the same way; copies are the kernels named ``*copy*``.
* ``hdw``: the same step in the plane-major layout
  (``stereo_matching_hdw``, ``extract_disparity_hdw``: K1, the plain head
  over the planes, K2 reading the cotangent as it comes).
* ``k3``: device time of the serving K3 (CUDA events).
* ``kernels``: device time of each banded kernel, K1, K3, K3w, K3m, K2,
  K7, K4, K6 and K5 (CUDA events, the median of 10 chained calls of 3),
  on the speckle pair, a random volume cotangent and random head
  cotangents, of K8 on a random 330x422 pair (k=15), of K9a and K9b on
  the cotangent, and of the HBM probes K10b and K10c at their volume.
* ``engine``: host-clock latency of ``StereoEngine.infer`` on KITTI
  frames, as ``chip_smoke.py``'s serving phase measures it.
* ``autotune``: the same latency without and with ``autotune`` (each
  bucket's K3 tile tuned from an empty cache, ``ops.tuning``), at KITTI
  (bucket 384x1280, D=192) and at ``serve``'s capture (330x422 in
  384x512, D=48), in the order untuned, tuned, tuned, untuned; then
  ``serve``'s own per-frame p50 without and with ``--autotune``.
* ``allpairs``: the all-pairs step at 330x422, k=15 (the default
  ``StereoConfig``), its first call and the median of warm ones.
* ``launch``: the host time of one call of the K3w and of the K4 wrapper
  (their kernels enqueued, not waited for) at KITTI size.
* ``build``: wall time of the kernel build as the port makes it (one
  nvcc per source, all started together, then a link) and as a single
  nvcc over every source, alternated, each into an empty directory.
* ``large_k``: the large-k route (``ops/cuda_large_k.py``) through its
  entry functions: each of its ten routes (K1L, K3L, K3wL, K3mL, K2L,
  K6L, K4L, K5L, K7L at KITTI with k = 129, K8L at 330x422 with k = 145)
  under ``torch.profiler``, the device time of a call by kernel name and
  the share of the window-sum kernels (``box_axis``, ``row_products``);
  then the route against K2, K4, K5, K6 and K7 on their own blocks at
  KITTI with k = 63, 95 and 127 (CUDA events: own, route, route, own,
  each the median of 5 calls; each pair's gradients compared
  norm-relative).

To compare two checkouts in one run (``train``, ``free``, ``k3``,
``kernels``, ``engine``, ``allpairs``, ``launch``), run this file by its
path with ``PYTHONPATH`` set to each checkout in turn: the package is
then imported from there.

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

# Only what the serving slice already had is imported here, so ``k3`` runs
# against a checkout of that slice too.
from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.data import make_stereo_pair
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.cuda_pipeline import stereo_pipeline_cuda
from custereomatching_tpu_torch.utils import benchmark
from custereomatching_tpu_torch.utils import kernel_model as km

KITTI = (375, 1242, 192, 15)
STEPS = 10
# Chrome-trace categories of device work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[str, float, float]


def device_intervals(trace_events: Iterable[dict]) -> List[Interval]:
    """``(name, start_us, end_us)`` of every device event of a Chrome
    trace's ``traceEvents``."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace_events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of the intervals: the time the device was busy
    (concurrent streams are not counted twice)."""
    total, end = 0.0, float("-inf")
    for _, lo, hi in sorted(intervals, key=lambda x: x[1]):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def per_name_us(intervals: Iterable[Interval]) -> Dict[str, float]:
    """Summed duration of each name's intervals, largest first."""
    sums: Dict[str, float] = defaultdict(float)
    for name, lo, hi in intervals:
        sums[name] += hi - lo
    return dict(sorted(sums.items(), key=lambda kv: -kv[1]))


def scene(seed: int = 60):
    """A KITTI-size speckle pair on the card, a noisy camera to start from
    and the fused pipeline's soft disparity of the clean pair as target."""
    H, W, D, k = KITTI
    cam, proj, _ = make_stereo_pair(H, W, d_min=4.0, d_max=184.0, seed=seed)
    cam = torch.from_numpy(cam[None]).cuda()
    proj = torch.from_numpy(proj[None]).cuda()
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D))
    with torch.no_grad():
        target = model.disparity_maps(cam, proj).soft_disparity
    noise = np.random.default_rng(seed + 1).standard_normal(cam.shape)
    camera0 = cam + torch.from_numpy((0.05 * noise).astype(np.float32)).cuda()
    return model, camera0, proj, target


def profile_steps(label: str, step: Callable[[], None]) -> dict:
    """Unprofiled host-clock median of ``STEPS`` steps, then ``STEPS``
    steps under the profiler: per-kernel device ms a step, busy ms a step,
    the window's wall ms a step and its idle share."""
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(times))

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    intervals = device_intervals(events)
    if not intervals:
        raise RuntimeError(f"{label}: the trace holds no device events")
    busy_ms = busy_us(intervals) / 1e3 / STEPS
    names = per_name_us(intervals)
    copies_ms = sum(us for name, us in names.items()
                    if "copy" in name.lower()) / 1e3 / STEPS
    print(f"{label}: unprofiled step host-clock median {step_ms:.4f} ms "
          f"over {STEPS} steps")
    print(f"{label}: profiled window {STEPS} steps: wall {wall_ms:.4f} ms a "
          f"step, device busy {busy_ms:.4f} ms a step, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; estimate against the unprofiled "
          f"step: {1 - busy_ms / step_ms:.4f}")
    print(f"{label}: copies {copies_ms:.4f} ms a step; device time a step "
          f"by kernel:")
    for name, us in list(names.items())[:12]:
        print(f"{label}:   {us / 1e3 / STEPS:9.4f} ms  {name[:110]}")
    return {"step_ms": step_ms, "profiled_wall_ms": wall_ms,
            "busy_ms": busy_ms, "idle_share_profiled": 1 - busy_ms / wall_ms,
            "copies_ms": copies_ms,
            "top": {name[:110]: us / 1e3 / STEPS
                    for name, us in list(names.items())[:6]}}


def mode_train() -> dict:
    from custereomatching_tpu_torch.models import (
        adam,
        init_state,
        make_train_step,
    )

    model, camera0, proj, target = scene()
    state = init_state(camera0, adam(1e-3))
    step_fn = make_train_step(model)

    def step():
        nonlocal state
        state, _ = step_fn(state, proj, target)

    return profile_steps("train", step)


def mode_free() -> dict:
    from custereomatching_tpu_torch.models import adam, init_state
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        stereo_pipeline_trainable,
    )

    model, camera0, proj, target = scene()
    cfg = model.config
    state = init_state(camera0, adam(1e-3))

    def step():
        state.optimizer.zero_grad(set_to_none=True)
        maps = stereo_pipeline_trainable(
            state.camera, proj, cfg.num_disparities, cfg.kernel_size,
            cfg.epsilon, cfg.softargmax_beta, cfg.cost_threshold,
            save_volume=False)
        err = maps.soft_disparity - target
        torch.mean(err * err).backward()
        state.optimizer.step()

    return profile_steps("free", step)


def mode_volume() -> dict:
    model, camera0, proj, target = scene()
    camera = camera0.clone().requires_grad_(True)

    def step():
        camera.grad = None
        err = model(camera, proj).soft_disparity - target
        torch.mean(err * err).backward()

    return profile_steps("volume", step)


def mode_hdw() -> dict:
    from custereomatching_tpu_torch.ops import (
        extract_disparity_hdw,
        stereo_matching_hdw,
    )

    H, W, D, k = KITTI
    model, camera0, proj, target = scene()
    cfg = model.config
    camera = camera0.clone().requires_grad_(True)

    def step():
        camera.grad = None
        vol = stereo_matching_hdw(camera, proj, D, k, cfg.epsilon)
        r = extract_disparity_hdw(vol, D, H, W, cfg.cost_threshold,
                                  cfg.softargmax_beta)
        err = r.soft_disparity - target
        torch.mean(err * err).backward()

    return profile_steps("hdw", step)


def mode_k3() -> dict:
    H, W, D, k = KITTI
    _, camera0, proj, _ = scene()
    args = (camera0, proj, D, k, 1e-8, 50.0, 0.6)
    with torch.no_grad():
        ms = [1e3 * benchmark(stereo_pipeline_cuda, *args, warmup=2,
                              iters=10, chain=3)["median_s"]
              for _ in range(3)]
    print(f"k3: serving K3 from {Path(_build.__file__).parents[2]}: "
          f"medians {' '.join(f'{m:.4f}' for m in ms)} ms")
    return {"k3_ms": ms}


def kernel_cases() -> List[Tuple[str, Callable, tuple]]:
    """(name, wrapper, arguments) of each kernel ``kernels`` times: the
    banded ones and the layout conversions K9a and K9b at KITTI, K8 at
    330x422, the HBM probes K10b and K10c at their KITTI volume."""
    from custereomatching_tpu_torch.ops.cuda_allpairs import (
        cost_volume_allpairs_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
        fused_pipeline_train_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_zncc import (
        camera_grad_banded_cuda,
        cost_volume_banded_cuda,
        projector_grad_banded_cuda,
    )
    from custereomatching_tpu_torch.ops.layout import (
        parity_to_plane_major,
        plane_major_to_parity,
    )

    H, W, D, k = KITTI
    _, cam, proj, _ = scene()
    pipe = (cam, proj, D, k, 1e-8, 50.0, 0.6)
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        res = fused_pipeline_train_cuda(*pipe)[1]
        res_m = fused_pipeline_train_cuda(*pipe, False)[1]
        cost = cost_volume_banded_cuda(cam, proj, D, k, 1e-8)
        g = torch.randn((1, D + 1, H, W), device="cuda", generator=gen)
        g_parity = g.permute(0, 2, 3, 1).contiguous()
    gs = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
    gc = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
    acam, aproj = torch.rand((2, 1, 330, 422), device="cuda", generator=gen)
    vjp = (cam, proj, cost.permute(0, 3, 1, 2), g, D, k, 1e-8)
    return [
        ("K1", cost_volume_banded_cuda, (cam, proj, D, k, 1e-8)),
        ("K3", stereo_pipeline_cuda, pipe),
        ("K3w", fused_pipeline_train_cuda, pipe),
        ("K3m", fused_pipeline_train_cuda, pipe + (False,)),
        ("K2", camera_grad_banded_cuda, vjp),
        ("K7", projector_grad_banded_cuda, vjp),
        ("K4", fused_pipeline_bwd_cuda,
         (cam, proj, res, gs, gc, D, k, 1e-8, 50.0)),
        ("K6", camera_grad_banded_cuda, (cam, proj, None, g, D, k, 1e-8)),
        ("K5", fused_pipeline_bwd_cuda,
         (cam, proj, res_m, gs, gc, D, k, 1e-8, 50.0)),
        ("K8", cost_volume_allpairs_cuda, (acam, aproj, 15, 1e-8)),
        ("K9a", plane_major_to_parity, (g,)),
        ("K9b", parity_to_plane_major, (g_parity,)),
        ("K10b", km.hbm_read_probe,
         (torch.rand(km.HBM_SHAPE, device="cuda", generator=gen),)),
        ("K10c", km.hbm_write_probe, (*km.HBM_SHAPE, "cuda"))]


def mode_kernels() -> dict:
    out = {}
    for name, fn, args in kernel_cases():
        with torch.no_grad():
            out[name] = 1e3 * benchmark(fn, *args, warmup=2, iters=10,
                                        chain=3)["median_s"]
    print(f"kernels: from {Path(_build.__file__).parents[2]}: "
          + " ".join(f"{n} {ms:.4f}" for n, ms in out.items()) + " ms")
    return out


def mode_engine() -> dict:
    """Host-clock latency of ``StereoEngine.infer`` (numpy in, numpy out)
    on KITTI frames in the 384x1280 bucket, as ``chip_smoke.py``'s serving
    phase times it: three rounds of 8 frames after the warm-up."""
    from custereomatching_tpu_torch.models.engine import StereoEngine

    H, W, D, k = KITTI
    engine = StereoEngine(StereoConfig(kernel_size=k, num_disparities=D),
                          buckets=[(384, 1280)], device="cuda")
    engine.warmup()
    frames = [make_stereo_pair(H, W, d_min=4.0, d_max=184.0, seed=40 + i)
              for i in range(8)]
    rounds = []
    for _ in range(3):
        latency = []
        for cam, proj, _ in frames:
            t0 = time.perf_counter()
            engine.infer(cam, proj)
            latency.append(time.perf_counter() - t0)
        rounds.append(1e3 * float(np.median(latency)))
    print(f"engine: infer host-clock median of 8 frames, three rounds: "
          f"{' '.join(f'{m:.3f}' for m in rounds)} ms")
    return {"engine_infer_ms": rounds}


def _infer_ms(engine, frames) -> float:
    """Host-clock median of ``engine.infer`` over ``frames``."""
    latency = []
    for cam, proj in frames:
        t0 = time.perf_counter()
        engine.infer(cam, proj)
        latency.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(latency))


def mode_autotune() -> dict:
    """``StereoEngine.infer``'s host-clock median of 8 frames without and
    with ``autotune`` (tuned from an empty cache file), untuned, tuned,
    tuned, untuned, at KITTI and at serve's capture; then ``serve``'s p50
    of 8 frames without and with ``--autotune``."""
    import os

    from custereomatching_tpu_torch.examples import serve
    from custereomatching_tpu_torch.models.engine import StereoEngine
    from custereomatching_tpu_torch.ops import tuning

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CUSTEREO_TUNE_CACHE"] = str(Path(tmp) / "tune.json")
        tuning._CACHE.clear()
        try:
            for label, (H, W, D, bucket) in (
                    ("kitti", (375, 1242, 192, (384, 1280))),
                    ("capture", (330, 422, 48, (384, 512)))):
                frames = [make_stereo_pair(H, W, d_min=4.0,
                                           d_max=0.9 * D, seed=40 + i)[:2]
                          for i in range(8)]
                cfg = StereoConfig(kernel_size=15, num_disparities=D)
                engines = {}
                for tuned in (False, True):
                    t0 = time.perf_counter()
                    engines[tuned] = StereoEngine(
                        cfg, buckets=[bucket], autotune=tuned,
                        device="cuda")
                    engines[tuned].warmup()
                    out[f"{label}_warmup_s_{'tuned' if tuned else 'untuned'}"] \
                        = time.perf_counter() - t0
                ms = {False: [], True: []}
                for tuned in (False, True, True, False):
                    ms[tuned].append(_infer_ms(engines[tuned], frames))
                out[f"{label}_tile"] = engines[True].tuned_tiles[bucket]
                out[f"{label}_infer_ms_untuned"] = ms[False]
                out[f"{label}_infer_ms_tuned"] = ms[True]
                print(f"autotune: {label} {H}x{W} D={D} bucket {bucket}: "
                      f"tile {out[f'{label}_tile']}; infer median untuned "
                      f"{ms[False]} ms, tuned {ms[True]} ms")
            for flags in ([], ["--autotune"], ["--autotune"], []):
                rec = {}
                serve.main(["--loops", "8", *flags], rec)
                key = "serve_p50_ms_" + ("tuned" if flags else "untuned")
                out.setdefault(key, []).append(
                    float(np.percentile(rec["latency_ms"], 50)))
            print(f"autotune: serve p50 untuned {out['serve_p50_ms_untuned']}"
                  f" ms, --autotune {out['serve_p50_ms_tuned']} ms")
        finally:
            os.environ.pop("CUSTEREO_TUNE_CACHE", None)
    return out


def mode_allpairs() -> dict:
    """The all-pairs step of ``chip_smoke.py`` (the default all-pairs
    ``StereoMatcher`` at 330x422, k=15: K8, K8h, the mean soft
    disparity's backward through K8hb and K8b): its first call, then the
    host-clock median of ``STEPS`` more, each synchronised."""
    H, W, k = 330, 422, 15
    model = StereoMatcher(StereoConfig(kernel_size=k, backend="cuda"))
    cam_np, proj_np, _ = make_stereo_pair(H, W, d_min=2.0, d_max=12.0,
                                          noise=0.01, seed=0)
    proj = torch.from_numpy(proj_np[None]).cuda()
    times = []
    for _ in range(1 + STEPS):
        cam = torch.from_numpy(cam_np[None]).cuda().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(cam, proj).soft_disparity.mean().backward()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    warm = float(np.median(times[1:]))
    print(f"allpairs: step host clock, first call {times[0]:.3f} ms, then "
          f"median {warm:.3f} ms over {STEPS}")
    return {"allpairs_first_ms": times[0], "allpairs_step_ms": warm}


def mode_launch() -> dict:
    """Host cost of the train step's kernel wrappers: the host-clock time
    of one call of the K3w wrapper and of the K4 wrapper, each call only
    enqueuing its kernels (no synchronisation inside the timed call),
    median of 200 calls, each preceded by a synchronisation."""
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
        fused_pipeline_train_cuda,
    )

    H, W, D, k = KITTI
    _, camera0, proj, _ = scene()
    fwd = (camera0, proj, D, k, 1e-8, 50.0, 0.6)
    gen = torch.Generator("cuda").manual_seed(0)
    gs = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
    gc = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
    res = fused_pipeline_train_cuda(*fwd)[1]
    bwd = (camera0, proj, res, gs, gc, D, k, 1e-8, 50.0)
    out = {}
    for name, fn, args in (("k3w", fused_pipeline_train_cuda, fwd),
                           ("k4", fused_pipeline_bwd_cuda, bwd)):
        times = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            times.append(1e6 * (time.perf_counter() - t0))
        out[f"{name}_host_us"] = float(np.median(times))
    torch.cuda.synchronize()
    print(f"launch: host time of one call (enqueue only), median of 200: "
          f"K3w wrapper {out['k3w_host_us']:.1f} us, K4 wrapper "
          f"{out['k4_host_us']:.1f} us")
    return out


def mode_build() -> dict:
    """Alternate: parallel, single, single, parallel."""
    cu = [str(s) for s in _build.sources() if s.suffix == ".cu"]
    times: Dict[str, List[float]] = {"parallel": [], "single": []}
    build_dir = _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, how in enumerate(("parallel", "single", "single",
                                     "parallel")):
                out = Path(tmp) / f"{i}"
                out.mkdir()
                t0 = time.perf_counter()
                if how == "parallel":
                    _build.BUILD_DIR = out
                    _build.build()
                else:
                    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                                    "-shared", "-o", str(out / "single.so"),
                                    *cu], capture_output=True, text=True,
                                   check=True)
                times[how].append(time.perf_counter() - t0)
        finally:
            _build.BUILD_DIR = build_dir
    print(f"build: {len(cu)} sources; one nvcc per source in parallel + "
          f"link {times['parallel']} s; one nvcc over all "
          f"{times['single']} s")
    return {f"build_{how}_s": t for how, t in times.items()}


LARGE_K = 129
LARGE_K_AP = (330, 422, 145)
CROSS_K = (63, 95, 127)
# Substrings of the route's window-sum kernels in a trace's names.
WINDOW_KERNELS = ("box_axis", "row_products")


def large_k_cases() -> List[Tuple[str, Callable, tuple]]:
    """(name, route function, arguments) of the large-k route's ten
    routes through ``ops/cuda_large_k.py``: K1L-K7L at KITTI (D = 192) with
    k = 129 on ``kernel_variants.route_inputs``' fixed inputs, K8L on a
    random 330x422 pair at k = 145."""
    from custereomatching_tpu_torch.ops import cuda_large_k as lk
    from custereomatching_tpu_torch.scripts.kernel_variants import (
        route_calls,
        route_inputs,
    )

    H, W, D, _ = KITTI
    calls = route_calls(route_inputs(H, W, D, LARGE_K))
    Ha, Wa, ka = LARGE_K_AP
    gen = torch.Generator("cuda").manual_seed(0)
    acam, aproj = torch.rand((2, 1, Ha, Wa), device="cuda", generator=gen)
    return ([(name, fn, ()) for name, fn in calls.items()]
            + [("K8L", lk.allpairs_volume_large, (acam, aproj, ka, 1e-8))])


def route_profile(name: str, fn: Callable, args: tuple,
                  calls: int = 2) -> dict:
    """Device ms of one call of a route by kernel name (``calls`` calls
    under the profiler after a warm one) and the window-sum kernels'
    share of the route's device time."""
    with torch.no_grad():
        fn(*args)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            with torch.profiler.profile(activities=activities) as prof:
                for _ in range(calls):
                    fn(*args)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
    intervals = device_intervals(events)
    if not intervals:
        raise RuntimeError(f"large_k {name}: the trace holds no device "
                           f"events")
    names = {n: us / 1e3 / calls for n, us in per_name_us(intervals).items()}
    total = sum(names.values())
    window = {w: sum(ms for n, ms in names.items() if w in n)
              for w in WINDOW_KERNELS}
    share = sum(window.values()) / total
    print(f"large_k: {name} device {total:.4f} ms a call; "
          + ", ".join(f"{w} {ms:.4f} ms" for w, ms in window.items())
          + f"; window sums {share:.4f} of the route")
    for n, ms in list(names.items())[:8]:
        print(f"large_k: {name}   {ms:9.4f} ms  {n[:100]}")
    return {"device_ms": total, "window_share": share,
            **{f"{w}_ms": ms for w, ms in window.items()},
            "by_kernel": {n[:100]: ms for n, ms in names.items()}}


def cross_cases(k: int) -> List[Tuple[str, Callable, Callable]]:
    """(name, own-block call, route call) of K2, K4, K5, K6 and K7 at KITTI
    with ``k`` on ``kernel_variants.route_inputs``' fixed inputs: the
    wrapper on the kernel's own blocks and ``ops/cuda_large_k.py``'s route
    (``kernel_variants.route_calls``)."""
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_zncc import (
        camera_grad_banded_cuda,
        projector_grad_banded_cuda,
    )
    from custereomatching_tpu_torch.scripts.kernel_variants import (
        route_calls,
        route_inputs,
    )

    H, W, D, _ = KITTI
    x = route_inputs(H, W, D, k)
    route = route_calls(x)
    cam, proj, cost, g = x["cam"], x["proj"], x["cost"], x["cotangent"]
    head = (x["gsoft"], x["gconf"], D, k, 1e-8, 50.0)
    return [
        ("K2", lambda: camera_grad_banded_cuda(cam, proj, cost, g, D, k,
                                               1e-8), route["K2L"]),
        ("K4", lambda: fused_pipeline_bwd_cuda(cam, proj, x["residuals"],
                                               *head), route["K4L"]),
        ("K5", lambda: fused_pipeline_bwd_cuda(cam, proj, x["residuals_m"],
                                               *head), route["K5L"]),
        ("K6", lambda: camera_grad_banded_cuda(cam, proj, None, g, D, k,
                                               1e-8), route["K6L"]),
        ("K7", lambda: projector_grad_banded_cuda(cam, proj, cost, g, D, k,
                                                  1e-8), route["K7L"])]


def mode_large_k() -> dict:
    out = {"profile": {}, "cross": {}}
    for name, fn, args in large_k_cases():
        out["profile"][name] = route_profile(name, fn, args)
    torch.cuda.empty_cache()
    for k in CROSS_K:
        for name, own, route in cross_cases(k):
            with torch.no_grad():
                a, b = own(), route()
                rel = float((a - b).norm() / b.norm())
                ms = {}
                # own, route, route, own
                for side, fn in (("own", own), ("route", route),
                                 ("route", route), ("own", own)):
                    ms.setdefault(side, []).append(1e3 * benchmark(
                        fn, warmup=1, iters=5, chain=1)["median_s"])
            own_ms, route_ms = (float(np.mean(ms[s])) for s in ("own",
                                                                 "route"))
            print(f"large_k: {name} KITTI k={k}: own blocks {own_ms:.4f} "
                  f"ms, route {route_ms:.4f} ms, route / own "
                  f"{route_ms / own_ms:.3f}; |own - route| / |route| "
                  f"{rel:.2e}")
            out["cross"][f"{name} k={k}"] = {"own_ms": own_ms,
                                             "route_ms": route_ms,
                                             "rel_diff": rel}
        torch.cuda.empty_cache()
    return out


MODES = {"train": mode_train, "free": mode_free, "volume": mode_volume,
         "hdw": mode_hdw, "k3": mode_k3, "kernels": mode_kernels,
         "engine": mode_engine, "autotune": mode_autotune,
         "allpairs": mode_allpairs, "launch": mode_launch,
         "build": mode_build, "large_k": mode_large_k}


def main(argv: List[str]) -> int:
    if not argv or any(m not in MODES for m in argv):
        print(f"usage: device_profile MODE... (MODE in {sorted(MODES)})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("device_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    result = {}
    for mode in argv:
        result[mode] = MODES[mode]()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
