"""Benchmark of the port on one card: the KITTI pipeline headline and the
secondary measurements of the root ``bench.py``.

    python -m custereomatching_tpu_torch.bench
    python -m custereomatching_tpu_torch.bench --device cpu --height 24 \\
        --width 40 -D 8 -k 5 --chains 1 2 --repeats 1 --allpairs 16 24

The counterpart of the root ``bench.py``.  The headline,
``kitti_stereo_pipeline_frames_per_s_per_chip``, is the frames a second of
``StereoMatcher.disparity_maps`` (K3 on the card) on one 375x1242 pair,
D = 192, k = 15, host dispatch included: a chain of n calls is timed by
the host clock and ends in ``torch.cuda.synchronize()``, and the time a
call is the median over ``--repeats`` pairs of the slope between a chain
of n1 and one of n2 calls (the JAX bench's ``_time``, after 3 warm-up
calls and a throwaway chain of n2).  ``vs_baseline`` is those frames/s
times K3's least-work time at the card's published peaks
(``utils.profiling.banded_bounds``), so it reads the same work whatever
design runs; ``model_ms``, K3's counted work at this run's K10 rates
(``utils.kernel_model``), stands beside it on stderr.

The secondary measurements, each under a stable name in ``secondary``
(ms, frames/s, px or a fraction), each timed path beside its least-work
bound (sums of ``banded_bounds`` entries) and its model: a batch of 4
frames; the pyramid matcher; the fused train step (K3w + K4, the value
and camera gradient of a mean-square soft-disparity loss); the volume op
in the parity layout (``cost_volume_single``: K1; forward + backward with
an all-ones parity cotangent: K1, the cotangent restaged plane-major, K2)
and in the plane-major layout (``ops.stereo_matching_hdw``: K1, K2); the
volume-write speed of light; the reference's verify workload, all-pairs
330x422 (K8, its plain VJP); the pyramid's accuracy; a stage of a
4-stage disparity-range pipeline (``parallel.pipeline.chunk_state``: K3m,
all four head maps returned); the engine's 384x1280 bucket, device side;
end to end from PNG files on disk (24 noisy frames decoded by the native
``FrameLoader`` where it builds, else one at a time by
``data.load_image_gray``, whose decoder is printed; decoding alone, then
decoding overlapping the card's compute, best of 3); the parity check
(EPE, bad3 and coverage against the truth, and the hard disparity
against the plain volume and head, each differing pixel classed as a
top-two tie or a confidence within 1e-5 of the threshold); the projector
gradient (K7) and the both-gradients step (K1, K2, K7).

Before measuring, on the card: the health probe
(``scripts.device_probe``) in a subprocess, two attempts; then the record
``chip_smoke.py`` writes under ``build/smoke/`` is read, with a warning
when it is missing, failed, from another card, stale or older than the
kernel sources.

Where it differs from the JAX bench:

* Stdout holds one line, printed last: the JSON summary, with JAX's four
  keys (``metric``, ``value``, ``unit``, ``vs_baseline``), ``device``
  (``name``, ``power_limit_w``, ``platform``: ``gpu``, or ``cpu`` under
  ``--device cpu``) and ``secondary``.  Everything else goes to stderr.
  The JAX bench prints its JSON mid-run.
* No measurement is skipped: a measurement that fails fails the run
  (exit 1, no JSON line), where JAX's reports "skipped" and goes on.
  Without a card the run exits 1 before measuring, unless ``--device
  cpu`` asks for the CPU (the plain versions; for the tests); a probe
  that finds the card degraded exits 2.
* TPU geometry is not carried over: no padded extents, no table of TPU
  bandwidths.  Bounds are least work at the card's published peaks
  (``utils.profiling``), models the counted work at this run's K10 rates.
* A stage of the pipeline takes ``ceil((D + 1) / S)`` planes, as the
  port's pipeline does (JAX's bench took ``(D + 1) // S``).
* Every timed output stays live: a forward + backward returns the
  volume with the gradient, the stage op its four maps.

Exit codes: 0 measured; 1 no card, or a measurement failed; 2 the card's
probe failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.data import kitti, make_stereo_pair
from custereomatching_tpu_torch.data.io import image_decoders, load_image_gray
from custereomatching_tpu_torch.models import (
    PyramidStereoMatcher,
    StereoEngine,
    StereoMatcher,
)
from custereomatching_tpu_torch.ops import (
    extract_disparity,
    stereo_matching_hdw,
    stereo_matching_torch,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    cost_volume_banded_cuda,
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.parallel.pipeline import (
    _stage_chunks,
    chunk_state,
)
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils.metrics import disparity_metrics
from custereomatching_tpu_torch.utils.profiling import (
    COUNTS,
    PEAK_BYTES,
    PEAK_FLOPS,
    allpairs_bound,
    banded_bounds,
    bound,
    card_line,
    device_specs,
)

METRIC = "kitti_stereo_pipeline_frames_per_s_per_chip"
KITTI = (375, 1242, 192, 15)
# The reference's own verify workload (all-pairs, k = 15).
VERIFY = (330, 422)
BATCH = 4
STAGES = 4
E2E_FRAMES = 24
E2E_BEST_OF = 3
WARMUP = 3
# Each row's chains (n1, n2): the JAX bench's.
CHAINS = {"pipeline": (10, 50), "batched": (10, 50), "pyramid": (10, 50),
          "train_step": (10, 50), "volume": (10, 50), "allpairs": (8, 40),
          "stage_op": (32, 160), "engine_bucket": (8, 40),
          "projector_grad": (4, 16), "both_grads_step": (4, 12)}
# Top-two ties and threshold flips: costs within this of each other.
TIE = 1e-5

REPO = Path(__file__).resolve().parents[1]
# Written by chip_smoke.py at its end; read before measuring.
SMOKE_RECORD = REPO / "build" / "smoke" / "chip_smoke.json"
SMOKE_STALE_DAYS = 14

# The kernels a run on the card must launch (``COUNTS``' names).
KERNELS = ("K1", "K2", "K3", "K3w", "K3m", "K4", "K7", "K8")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Bounds (least work at the published peaks) and the speed of light
# ---------------------------------------------------------------------------

def engine_bucket(H: int, W: int) -> Tuple[int, int]:
    """The serving bucket a frame pads to: H up to a multiple of 128, W of
    256 (KITTI's 375x1242 to the engine's 384x1280)."""
    return -(-H // 128) * 128, -(-W // 256) * 256


def speed_of_light(H: int, W: int, D: int, hbm_bw: float
                   ) -> Tuple[int, float]:
    """(bytes, frames/s) of the volume-write speed of light: the banded
    volume written and both images read, at ``hbm_bw`` bytes/s."""
    nbytes = H * W * (D + 1) * 4 + 2 * H * W * 4
    return nbytes, hbm_bw / nbytes


def path_bounds(H: int, W: int, D: int, k: int,
                allpairs: Tuple[int, int] = VERIFY) -> Dict[str, float]:
    """Least-work ms of each timed path at the data sheet's peaks: sums of
    ``banded_bounds`` entries (``allpairs_bound`` for K8; the all-pairs
    backward its mandatory traffic, ``allpairs_backward_cost``)."""
    b = {key: ms for key, (ms, _) in banded_bounds(1, H, W, D, k).items()}
    Hr, Wr = allpairs
    chunk = _stage_chunks(D, STAGES)
    bh, bw = engine_bucket(H, W)
    ap_bwd = km.allpairs_backward_cost(Hr, Wr, k)
    return {
        "pipeline": b["K3"],
        "batched_b4": banded_bounds(BATCH, H, W, D, k)["K3"][0] / BATCH,
        "train_step": b["K3w"] + b["K4"],
        "volume_parity_fwd": b["K1"],
        # The parity cotangent restaged plane-major: K9b's work.
        "volume_parity_fwd_bwd": b["K1"] + b["K9b"] + b["K2"],
        "volume_hdw_fwd": b["K1"],
        "volume_hdw_fwd_bwd": b["K1"] + b["K2"],
        "allpairs_fwd": allpairs_bound(1, Hr, Wr, k)[0],
        "allpairs_bwd": bound(0, ap_bwd.bytes)[0],
        "stage_op": banded_bounds(1, H, W, chunk - 1, k)["K3m"][0],
        "engine_bucket": banded_bounds(1, bh, bw, D, k)["K3"][0],
        "projector_grad": b["K7"],
        "both_grads_step": b["K1"] + b["K2"] + b["K7"],
    }


def path_costs(H: int, W: int, D: int, k: int,
               allpairs: Tuple[int, int] = VERIFY) -> Dict[str, km.OpCount]:
    """The counted work of each timed path that runs kernels only
    (``utils.kernel_model``'s cost functions); the parity backward's
    restage is plain ``permute().contiguous()``, its bytes priced at the
    measured ``t3d`` rate by :meth:`Run.model_ms`."""
    chunk = _stage_chunks(D, STAGES)
    bh, bw = engine_bucket(H, W)
    k1 = km.volume_forward_cost(H, W, D, k)
    k2 = km.volume_backward_cost(H, W, D, k, with_cost=True)
    k7 = km.projector_backward_cost(H, W, D, k)
    return {
        "pipeline": km.fused_forward_cost(H, W, D, k),
        "batched_b4": km.fused_forward_cost(H, W, D, k),
        "train_step": (km.fused_forward_cost(H, W, D, k, write_volume=True)
                       + km.fused_backward_c_cost(H, W, D, k)),
        "volume_parity_fwd": k1,
        "volume_parity_fwd_bwd": k1 + k2,
        "volume_hdw_fwd": k1,
        "volume_hdw_fwd_bwd": k1 + k2,
        "allpairs_fwd": km.allpairs_forward_cost(*allpairs, k),
        "stage_op": km.stage_op_cost(H, W, D, STAGES, k),
        "engine_bucket": km.fused_forward_cost(bh, bw, D, k),
        "projector_grad": k7,
        "both_grads_step": k1 + k2 + k7,
    }


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What every measurement reads: the device, the shape, the chains,
    the model and its inputs, the bounds, and the K10 rates (None off the
    card)."""

    device: torch.device
    H: int
    W: int
    D: int
    k: int
    repeats: int
    chains: Optional[Tuple[int, int]]
    allpairs: Tuple[int, int]
    model: StereoMatcher
    camera: torch.Tensor
    projector: torch.Tensor
    bounds: Dict[str, float]
    costs: Dict[str, km.OpCount]
    hbm_bw: float
    rates: Optional[Dict[str, float]]
    t_pipeline: float = 0.0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def scene(self, seed: int):
        """The JAX bench's synthetic scene (disparities 4..40 at KITTI,
        noise 0.01) at this run's shape: numpy camera, projector, truth."""
        d_max = max(4.0, min(40.0, 0.6 * self.D))
        return make_stereo_pair(self.H, self.W, d_min=4.0, d_max=d_max,
                                noise=0.01, seed=seed)

    def to(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def row_chains(self, row: str) -> Tuple[int, int]:
        return self.chains or CHAINS[row]

    def chain(self, fn, args, n: int) -> float:
        """Host seconds of ``n`` back-to-back calls ended by one
        synchronize; the last output stays live until then."""
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        self.sync()
        dt = time.perf_counter() - t0
        del out
        return dt

    def time(self, row: str, fn, *args) -> float:
        """Seconds a call: the median over ``repeats`` of the slope
        between chains of n1 and n2 calls, after ``WARMUP`` calls and a
        throwaway chain of n2 (which grows the allocator's pools)."""
        n1, n2 = self.row_chains(row)
        for _ in range(WARMUP):
            fn(*args)
        self.sync()
        self.chain(fn, args, n2)
        slopes = sorted((self.chain(fn, args, n2) - self.chain(fn, args, n1))
                        / (n2 - n1) for _ in range(self.repeats))
        return max(slopes[len(slopes) // 2], 1e-9)

    def model_ms(self, path: str) -> Optional[float]:
        """The path's counted work at this run's K10 rates, in ms; None
        off the card, where no rate is measured."""
        if self.rates is None or path not in self.costs:
            return None
        ms = 1e3 * km.kernel_bound(self.costs[path], self.rates,
                                   self.hbm_bw)["bound_s"]
        if path == "volume_parity_fwd_bwd":
            restage = km.transpose_volume_cost(self.H, self.W, self.D)
            ms += 1e3 * restage.bytes * self.rates["t3d"]
        return ms

    def timed(self, path: str, row: str, label: str, fn, *args,
              per: int = 1) -> Dict[str, Optional[float]]:
        """Time ``fn`` (seconds a call over ``per`` frames), print it beside
        its bound and model, and return the path's entries."""
        t = self.time(row, fn, *args) / per
        out = {f"{path}_ms": 1e3 * t}
        n1, n2 = self.row_chains(row)
        line = (f"{label}: {1e3 * t:.4f} ms ({1.0 / t:.1f} a second; "
                f"chains {n1}/{n2}, median of {self.repeats})")
        if path in self.bounds:
            b = self.bounds[path]
            m = self.model_ms(path)
            out[f"{path}_bound_ms"] = b
            line += f"; bound {b:.4f} ms -> {100 * b / (1e3 * t):.1f}%"
            if path in self.costs:
                out[f"{path}_model_ms"] = m
                line += ("; model not measured" if m is None
                         else f"; model {m:.4f} ms")
        log(line)
        return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    H, W, D, k = KITTI
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--disparities", "-D", type=int, default=D)
    ap.add_argument("--kernel-size", "-k", type=int, default=k)
    ap.add_argument("--allpairs", type=int, nargs=2, default=list(VERIFY),
                    metavar=("H", "W"),
                    help="shape of the all-pairs workload (330 422)")
    ap.add_argument("--chains", type=int, nargs=2, default=None,
                    metavar=("N1", "N2"),
                    help="chain lengths of every row (default: each row's "
                    "from the JAX bench)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="chain pairs a measurement, their median slope")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.disparities < 1:
        ap.error("-D must be >= 1 (the parity check ranks two planes)")
    if args.chains is not None and not 1 <= args.chains[0] < args.chains[1]:
        ap.error("--chains needs 1 <= N1 < N2")
    if args.repeats < 1:
        ap.error("--repeats must be >= 1")
    return args


def setup(args: argparse.Namespace, device: torch.device) -> Run:
    """The run's model and inputs (``np.random.default_rng(0)``, as the JAX
    bench), its bounds and, on the card, this run's K10 rates."""
    H, W, D, k = (args.height, args.width, args.disparities,
                  args.kernel_size)
    rng = np.random.default_rng(0)
    camera = rng.random((H, W), dtype=np.float32)
    projector = rng.random((H, W), dtype=np.float32)
    allpairs = tuple(args.allpairs)
    cuda = device.type == "cuda"
    rates = km.measure_vpu_rates(force=True) if cuda else None
    hbm_bw = device_specs(device)["hbm_bw"] if cuda else PEAK_BYTES
    return Run(device=device, H=H, W=W, D=D, k=k, repeats=args.repeats,
               chains=tuple(args.chains) if args.chains else None,
               allpairs=allpairs,
               model=StereoMatcher(StereoConfig(kernel_size=k,
                                                num_disparities=D)),
               camera=torch.from_numpy(camera).to(device),
               projector=torch.from_numpy(projector).to(device),
               bounds=path_bounds(H, W, D, k, allpairs),
               costs=path_costs(H, W, D, k, allpairs),
               hbm_bw=hbm_bw, rates=rates)


# ---------------------------------------------------------------------------
# Measurements (rows of the JAX bench), each returning its secondary entries
# ---------------------------------------------------------------------------

def measure_pipeline(run: Run) -> Dict:
    """The headline: ``disparity_maps`` on one pair (K3)."""
    def pipe(c, p):
        return run.model.disparity_maps(c[None], p[None]).soft_disparity

    with torch.no_grad():
        t0 = time.perf_counter()
        pipe(run.camera, run.projector)
        run.sync()
        first_ms = 1e3 * (time.perf_counter() - t0)
        log(f"first disparity_maps call: {first_ms:.1f} ms (host clock)")
        out = run.timed("pipeline", "pipeline",
                        f"fused pipeline {run.H}x{run.W} D={run.D} "
                        f"k={run.k} (disparity_maps)", pipe, run.camera,
                        run.projector)
    run.t_pipeline = out["pipeline_ms"] / 1e3
    return out


def measure_batched(run: Run) -> Dict:
    """``disparity_maps`` on a batch of 4 frames, per frame (K3)."""
    cam = torch.stack([run.camera] * BATCH)
    proj = torch.stack([run.projector] * BATCH)
    with torch.no_grad():
        out = run.timed(
            "batched_b4", "batched", f"batched B={BATCH}, per frame",
            lambda c, p: run.model.disparity_maps(c, p).soft_disparity,
            cam, proj, per=BATCH)
    return {"batched_b4_ms_per_frame": out["batched_b4_ms"],
            "batched_b4_frames_per_s": 1e3 / out["batched_b4_ms"],
            "batched_b4_bound_ms_per_frame": out["batched_b4_bound_ms"],
            "batched_b4_model_ms_per_frame": out["batched_b4_model_ms"]}


def measure_pyramid(run: Run) -> Dict:
    """``PyramidStereoMatcher`` on one pair (K3 twice)."""
    pyr = PyramidStereoMatcher(run.model.config)
    with torch.no_grad():
        out = run.timed("pyramid", "pyramid", "pyramid matcher",
                        lambda c, p: pyr(c[None], p[None]).soft_disparity,
                        run.camera, run.projector)
    out["pyramid_frames_per_s"] = 1e3 / out["pyramid_ms"]
    return out


def measure_train_step(run: Run) -> Dict:
    """The value and camera gradient of a mean-square soft-disparity loss
    through ``trainable_disparity_maps`` (K3w + K4)."""
    cam = run.camera.clone().requires_grad_(True)
    target = torch.zeros_like(run.camera)

    def step(c, p, tgt):
        maps = run.model.trainable_disparity_maps(c[None], p[None])
        loss = torch.mean((maps.soft_disparity[0] - tgt) ** 2)
        grad, = torch.autograd.grad(loss, c)
        return loss.detach(), grad

    return run.timed("train_step", "train_step",
                     "fused train step (K3w + loss + K4)", step, cam,
                     run.projector, target)


def measure_volume_parity(run: Run) -> Dict:
    """``cost_volume_single`` (the parity ``[H, W, D+1]`` layout, K1),
    then forward + backward with an all-ones parity cotangent, returning
    the volume with the camera gradient (K1, the restage, K2)."""
    with torch.no_grad():
        out = run.timed("volume_parity_fwd", "volume",
                        "volume op, parity layout, forward",
                        run.model.cost_volume_single, run.camera,
                        run.projector)
    cam = run.camera.clone().requires_grad_(True)
    ones = torch.ones((run.H, run.W, run.D + 1), device=run.device)

    def fwd_bwd(c, p, g):
        cost = run.model.cost_volume_single(c, p)
        grad, = torch.autograd.grad(cost, c, g)
        return cost.detach(), grad

    out.update(run.timed("volume_parity_fwd_bwd", "volume",
                         "volume op, parity layout, forward + backward",
                         fwd_bwd, cam, run.projector, ones))
    return out


def measure_volume_hdw(run: Run) -> Dict:
    """``stereo_matching_hdw`` (plane-major ``[1, D+1, H, W]``, K1), then
    forward + backward with an all-ones cotangent (K1, K2)."""
    D, k = run.D, run.k
    with torch.no_grad():
        out = run.timed("volume_hdw_fwd", "volume",
                        "volume op, plane-major, forward",
                        lambda c, p: stereo_matching_hdw(c[None], p[None],
                                                         D, k),
                        run.camera, run.projector)
    cam = run.camera.clone().requires_grad_(True)
    ones = torch.ones((1, D + 1, run.H, run.W), device=run.device)

    def fwd_bwd(c, p, g):
        vol = stereo_matching_hdw(c[None], p[None], D, k)
        grad, = torch.autograd.grad(vol, c, g)
        return vol.detach(), grad

    out.update(run.timed("volume_hdw_fwd_bwd", "volume",
                         "volume op, plane-major, forward + backward",
                         fwd_bwd, cam, run.projector, ones))
    return out


def measure_speed_of_light(run: Run) -> Dict:
    """The volume-write speed of light: the volume and both images at the
    card's HBM rate (no timing)."""
    nbytes, fps = speed_of_light(run.H, run.W, run.D, run.hbm_bw)
    log(f"volume-write speed of light {fps:.1f} frames/s ({1e3 / fps:.4f} "
        f"ms; {nbytes / 1e9:.3f} GB a frame at {run.hbm_bw / 1e12:.2f} TB/s)")
    return {"speed_of_light_frames_per_s": fps,
            "speed_of_light_ms": 1e3 / fps}


def measure_allpairs(run: Run) -> Dict:
    """The reference's verify workload: the all-pairs ``[1, H, W, W]``
    volume (K8), and forward + backward with an all-ones cotangent (K8,
    then K8b), the volume returned with the gradient."""
    Hr, Wr = run.allpairs
    rng = np.random.default_rng(1)
    cam = run.to(rng.random((Hr, Wr), dtype=np.float32))
    proj = run.to(rng.random((Hr, Wr), dtype=np.float32))
    model = StereoMatcher(StereoConfig(kernel_size=run.k))
    with torch.no_grad():
        out = run.timed("allpairs_fwd", "allpairs",
                        f"all-pairs {Hr}x{Wr} k={run.k}, forward",
                        lambda c, p: model.cost_volume(c[None], p[None]),
                        cam, proj)
    cam_g = cam.clone().requires_grad_(True)
    ones = torch.ones((1, Hr, Wr, Wr), device=run.device)

    def fwd_bwd(c, p, g):
        cost = model.cost_volume(c[None], p[None])
        grad, = torch.autograd.grad(cost, c, g)
        return cost.detach(), grad

    out.update(run.timed("allpairs_fwd_bwd", "allpairs",
                         "all-pairs forward + backward", fwd_bwd, cam_g,
                         proj, ones))
    bwd = max(out["allpairs_fwd_bwd_ms"] - out["allpairs_fwd_ms"], 1e-6)
    b = run.bounds["allpairs_bwd"]
    log(f"all-pairs backward alone {bwd:.4f} ms (the difference of the two "
        f"slopes); its traffic bound {b:.4f} ms -> {100 * b / bwd:.1f}%")
    out.update(allpairs_bwd_ms=bwd, allpairs_bwd_bound_ms=b)
    return out


def measure_pyramid_accuracy(run: Run) -> Dict:
    """The pyramid's EPE, bad3 and coverage on the JAX bench's scene."""
    cam, proj, truth = run.scene(seed=0)
    pyr = PyramidStereoMatcher(run.model.config)
    with torch.no_grad():
        maps = pyr(run.to(cam)[None], run.to(proj)[None])
    m = disparity_metrics(maps.soft_disparity[0], run.to(truth),
                          maps.mask[0])
    log(f"pyramid accuracy: EPE {m['epe']:.4f} px, bad3 {m['bad3']:.4f}, "
        f"coverage {m['coverage']:.4f}")
    return {"pyramid_epe_px": m["epe"], "pyramid_bad3": m["bad3"],
            "pyramid_coverage": m["coverage"]}


def measure_stage_op(run: Run) -> Dict:
    """One stage of a 4-stage disparity-range pipeline on the scene
    (``chunk_state``: K3m over ``ceil((D+1)/4)`` planes), all four head
    maps returned."""
    cam, proj, _ = run.scene(seed=0)
    chunk = _stage_chunks(run.D, STAGES)
    cfg = run.model.config

    def stage_op(c, p):
        return tuple(chunk_state(c, p, 0, chunk, cfg))

    with torch.no_grad():
        out = run.timed("stage_op", "stage_op",
                        f"pipeline stage op (S={STAGES}, {chunk} planes)",
                        stage_op, run.to(cam), run.to(proj))
    log(f"stage op against the full-range pipeline "
        f"{1e3 * run.t_pipeline:.4f} ms: steady-state speed-up "
        f"{1e3 * run.t_pipeline / out['stage_op_ms']:.2f}x at {STAGES} "
        f"stages")
    return out


def measure_engine_bucket(run: Run) -> Dict:
    """The engine's bucket function, warm, on the scene padded to the
    bucket already on the device (K3 at the bucket's shape)."""
    bucket = engine_bucket(run.H, run.W)
    cam, proj, _ = run.scene(seed=0)
    engine = StereoEngine(run.model.config, buckets=[bucket],
                          device=run.device)
    engine.warmup()
    fn = engine._fn_for(bucket)
    bc = torch.zeros((1,) + bucket, device=run.device)
    bp = torch.zeros((1,) + bucket, device=run.device)
    bc[0, :run.H, :run.W] = run.to(cam)
    bp[0, :run.H, :run.W] = run.to(proj)
    with torch.no_grad():
        out = run.timed("engine_bucket", "engine_bucket",
                        f"engine bucket {bucket[0]}x{bucket[1]} (warm, "
                        f"device side)",
                        lambda c, p: fn(c, p).soft_disparity, bc, bp)
    log(f"bucket-pad overhead against the pipeline "
        f"{100 * (out['engine_bucket_ms'] / (1e3 * run.t_pipeline) - 1):+.1f}%")
    out["engine_bucket_frames_per_s"] = 1e3 / out["engine_bucket_ms"]
    return out


@contextlib.contextmanager
def frame_source(paths: List[str]):
    """``(name, frames)``: the native ``FrameLoader`` (a decode pool, in
    path order) where the library builds, else ``load_image_gray`` one
    frame at a time, as ``serve.py`` and ``video_depth.py`` read."""
    if native.native_available():
        with native.FrameLoader(paths) as loader:
            yield "native FrameLoader", loader
    else:
        yield (f"load_image_gray via {image_decoders()[0]}",
               (load_image_gray(p) for p in paths))


def measure_e2e(run: Run) -> Dict:
    """End to end with host decoding: 24 noisy 8-bit PNG frames of the
    scene on disk; after one frame decoded and run (the decoder's import,
    the warm-up), decoding alone, then each frame decoded, copied to the
    device and through ``disparity_maps`` (decoding overlapping the
    card's compute), one synchronize at the end, best of 3."""
    cam, proj, _ = run.scene(seed=1)
    base = (np.clip(cam, 0.0, 1.0) * 255).round().astype(np.uint8)
    rng = np.random.default_rng(5)
    proj_d = run.to(proj)

    def pipe(c):
        return run.model.disparity_maps(c[None], proj_d[None]).soft_disparity

    with tempfile.TemporaryDirectory(prefix="custereo_bench_") as tmp, \
            torch.no_grad():
        paths = []
        for f in range(E2E_FRAMES):
            img = np.clip(base.astype(np.int16)
                          + rng.integers(-2, 3, size=base.shape),
                          0, 255).astype(np.uint8)
            paths.append(os.path.join(tmp, f"f{f:03d}.png"))
            kitti._write_png_gray(paths[-1], img, 8)
        # One frame decoded and run first: the decoder's import and the
        # pipeline's warm-up stay out of both legs.
        with frame_source(paths[:1]) as (_, frames):
            pipe(torch.from_numpy(next(iter(frames))).to(run.device))
        run.sync()
        t0 = time.perf_counter()
        with frame_source(paths) as (name, frames):
            n = sum(1 for _ in frames)
        t_dec = (time.perf_counter() - t0) / n
        if n != E2E_FRAMES:
            raise RuntimeError(f"decoded {n} of {E2E_FRAMES} frames")
        best = math.inf
        for _ in range(E2E_BEST_OF):
            t0 = time.perf_counter()
            out = None
            with frame_source(paths) as (_, frames):
                for frame in frames:
                    out = pipe(torch.from_numpy(frame).to(run.device))
            run.sync()
            best = min(best, (time.perf_counter() - t0) / E2E_FRAMES)
            del out
    log(f"end to end (PNG on disk -> {name} -> device -> maps): "
        f"{1e3 * best:.4f} ms a frame ({1.0 / best:.1f} frames/s), best of "
        f"{E2E_BEST_OF} streams of {E2E_FRAMES}; decoding alone "
        f"{1e3 * t_dec:.4f} ms a frame on {os.cpu_count()} host cores; "
        f"the pipeline alone {1e3 * run.t_pipeline:.4f} ms")
    return {"e2e_ms_per_frame": 1e3 * best, "e2e_frames_per_s": 1.0 / best,
            "e2e_decode_ms_per_frame": 1e3 * t_dec, "e2e_decoder": name}


def measure_parity(run: Run) -> Dict:
    """The parity check on the scene: EPE, bad3 and coverage of
    ``disparity_maps`` against the truth, and its hard disparity against
    the plain volume and head (``stereo_matching_torch`` +
    ``extract_disparity``): the largest difference, the differing pixels,
    and how many of them are top-two ties (two largest costs within 1e-5)
    or, failing that, a confidence within 1e-5 of the threshold."""
    cam, proj, truth = run.scene(seed=0)
    cam, proj = run.to(cam), run.to(proj)
    c = run.model.config
    with torch.no_grad():
        maps = run.model.disparity_maps(cam[None], proj[None])
        vol = stereo_matching_torch(cam, proj, run.D, run.k, c.epsilon)
        ref = extract_disparity(vol, run.D, c.cost_threshold,
                                c.softargmax_beta)
        top2 = torch.topk(vol, 2, dim=-1).values
    m = disparity_metrics(maps.soft_disparity[0], run.to(truth),
                          maps.mask[0])
    hard = maps.disparity[0]
    differ = hard != ref.disparity
    tie = (top2[..., 0] - top2[..., 1]) <= TIE
    flip = ((maps.mask[0] != ref.mask)
            & ((ref.confidence - c.cost_threshold).abs() <= TIE))
    out = {"parity_epe_px": m["epe"], "parity_bad3": m["bad3"],
           "parity_coverage": m["coverage"],
           "parity_max_hard_diff": float((hard - ref.disparity).abs().max()),
           "parity_differing_pixels": int(differ.sum()),
           "parity_differing_top2_ties": int((differ & tie).sum()),
           "parity_differing_threshold_flips":
               int((differ & ~tie & flip).sum())}
    log(f"parity: EPE against the truth {m['epe']:.4f} px (bad3 "
        f"{m['bad3']:.4f}, coverage {m['coverage']:.4f}); hard disparity "
        f"against the plain path: max difference "
        f"{out['parity_max_hard_diff']:g}, {out['parity_differing_pixels']} "
        f"pixels differ, {out['parity_differing_top2_ties']} of them top-two "
        f"ties, {out['parity_differing_threshold_flips']} confidences at the "
        f"threshold")
    return out


def measure_projector_grad(run: Run) -> Dict:
    """K7 on a written volume with an all-ones cotangent, then the
    both-gradients step: ``stereo_matching_hdw(..., grad_projector=True)``
    forward and both gradients (K1, K2, K7), the volume returned with
    them."""
    D, k = run.D, run.k
    cam, proj = run.camera[None], run.projector[None]
    with torch.no_grad():
        vol = cost_volume_banded_cuda(cam, proj, D, k).permute(0, 3, 1, 2)
    ones = torch.ones_like(vol)
    out = run.timed("projector_grad", "projector_grad",
                    "projector-gradient kernel (K7)",
                    projector_grad_banded_cuda, cam, proj, vol, ones, D, k)
    cam_g = run.camera.clone().requires_grad_(True)
    proj_g = run.projector.clone().requires_grad_(True)
    ones_pm = torch.ones((1, D + 1, run.H, run.W), device=run.device)

    def both(c, p, g):
        v = stereo_matching_hdw(c[None], p[None], D, k, grad_projector=True)
        gc, gp = torch.autograd.grad(v, (c, p), g)
        return v.detach(), gc, gp

    out.update(run.timed("both_grads_step", "both_grads_step",
                         "both-gradients step (K1, K2, K7)", both, cam_g,
                         proj_g, ones_pm))
    return out


# ---------------------------------------------------------------------------
# Preflight and the smoke record
# ---------------------------------------------------------------------------

def preflight(attempts: int = 2, wait_s: float = 20.0,
              timeout_s: float = 300.0) -> bool:
    """The card's health probe (``scripts.device_probe``: a bf16 matmul and
    K10a's madd rate) in a subprocess with a timeout, so a hung card
    cannot hang the bench; a second attempt after ``wait_s``."""
    cmd = [sys.executable, "-m", "custereomatching_tpu_torch.scripts."
           "device_probe"]
    for i in range(attempts):
        try:
            r = subprocess.run(cmd, cwd=REPO, timeout=timeout_s,
                               capture_output=True, text=True)
            lines = (r.stdout + r.stderr).strip().splitlines()
            if r.returncode == 0:
                for line in lines:
                    log(f"preflight: {line}")
                return True
            reason = lines[-1] if lines else f"probe exit {r.returncode}"
        except subprocess.TimeoutExpired:
            reason = f"device probe hung past {timeout_s:.0f} s"
        log(f"preflight attempt {i + 1}/{attempts}: {reason}")
        if i + 1 < attempts:
            time.sleep(wait_s)
    return False


def sources_digest() -> str:
    """SHA-256 of the kernel sources and their wrappers (``csrc/``,
    ``ops/``)."""
    pkg = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for sub in ("csrc", "ops"):
        for f in sorted((pkg / sub).rglob("*")):
            if f.is_file() and f.suffix in (".cu", ".cuh", ".py"):
                h.update(f.relative_to(pkg).as_posix().encode() + b"\0")
                h.update(f.read_bytes())
    return h.hexdigest()


def write_smoke_record(passed: bool, card: str,
                       path: Path = SMOKE_RECORD) -> None:
    """The record of a ``chip_smoke.py`` run that the bench reads: pass or
    fail, the card's name and power limit (``card``, as ``nvidia-smi``
    prints them), the time and the sources' digest."""
    name, _, limit = card.rpartition(",")
    now = time.time()
    rec = {"pass": passed, "device": name.strip(),
           "power_limit": limit.strip(), "unix_time": now,
           "time_utc": datetime.datetime.fromtimestamp(
               now, datetime.timezone.utc).isoformat(timespec="seconds"),
           "sources_digest": sources_digest()}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1) + "\n")


def smoke_status(device_name: str, path: Path = SMOKE_RECORD) -> List[str]:
    """Warn (stderr) when the last ``chip_smoke.py`` record is missing,
    failed, from another card, stale or older than the kernel sources;
    returns the warnings.  It only warns, as the JAX bench's does."""
    try:
        rec = json.loads(path.read_text())
    except (OSError, ValueError):
        issues = [f"no smoke record ({path} missing): run chip_smoke.py"]
    else:
        issues = []
        if not rec.get("pass"):
            issues.append("the last chip_smoke.py run FAILED")
        if rec.get("device") != device_name:
            issues.append(f"recorded on {rec.get('device')!r}, benching "
                          f"{device_name!r}")
        age_d = (time.time() - rec.get("unix_time", 0.0)) / 86400.0
        if age_d > SMOKE_STALE_DAYS:
            issues.append(f"stale ({age_d:.0f} days old)")
        if rec.get("sources_digest") != sources_digest():
            issues.append("kernel sources (csrc/, ops/) changed since the "
                          "recorded run")
        if not issues:
            log(f"chip_smoke.py: PASS recorded {rec.get('time_utc')} on "
                f"{rec.get('device')}, {rec.get('power_limit')}")
    for issue in issues:
        log(f"WARNING: smoke record: {issue}")
    return issues


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def device_info(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "platform": "cpu"}
    line = card_line()
    limit = line.rpartition(",")[2].strip().split()[0]
    return {"name": torch.cuda.get_device_name(device),
            "power_limit_w": float(limit), "platform": "gpu"}


def run_all(args: argparse.Namespace, device: torch.device) -> Dict:
    """Every measurement in the JAX bench's order; returns the summary."""
    info = device_info(device)
    log(f"device {info['name']} ({info['platform']}), power limit "
        f"{info['power_limit_w']} W; torch {torch.__version__}")
    if device.type == "cuda":
        smoke_status(info["name"])
    run = setup(args, device)
    before = COUNTS.copy()
    secondary = measure_pipeline(run)
    for measure in (measure_batched, measure_pyramid, measure_train_step,
                    measure_volume_parity, measure_volume_hdw,
                    measure_speed_of_light, measure_allpairs,
                    measure_pyramid_accuracy, measure_stage_op,
                    measure_engine_bucket, measure_e2e, measure_parity,
                    measure_projector_grad):
        secondary.update(measure(run))
    ran = COUNTS - before
    launches = {name: ran[name] for name in KERNELS}
    log(f"kernel launches in this run: {launches}")
    if run.cuda and not all(launches.values()):
        raise RuntimeError(f"a kernel of the bench's paths never launched: "
                           f"{launches}")
    fps = 1e3 / secondary["pipeline_ms"]
    t_bound = run.bounds["pipeline"] / 1e3
    model = secondary["pipeline_model_ms"]
    log(f"headline {fps:.3f} frames/s; K3's least-work bound "
        f"{1e3 * t_bound:.4f} ms (published peaks {PEAK_BYTES / 1e12:.2f} "
        f"TB/s, {PEAK_FLOPS / 1e12:.0f} TFLOP/s fp32) -> vs_baseline "
        f"{fps * t_bound:.4f}; model "
        + ("not measured" if model is None else f"{model:.4f} ms"))
    return {"metric": METRIC, "value": fps, "unit": "frames/s",
            "vs_baseline": fps * t_bound, "device": info,
            "secondary": secondary}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        device = entry_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda" and not preflight():
        print("bench: the card is unreachable or degraded; no result",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        # Library output goes to stderr: stdout holds the summary alone.
        with contextlib.redirect_stdout(sys.stderr):
            summary = run_all(args, device)
    except Exception:
        traceback.print_exc()
        print("bench: a measurement failed; no result", file=sys.stderr)
        return 1
    log(f"measured in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
