"""Profiling: device traces, the port's spans, the card's published peaks
and the least-work bounds of the port's kernels.

The counterpart of ``custereomatching_tpu/utils/profiling.py``: (a) a
context manager around ``torch.profiler`` that exports a Chrome trace,
:func:`span`, the port's named ranges in such a trace, and ``COUNTS``,
its record of what ran, (b) the data
sheet's peaks by card name, (c) the roofline of one ZNCC frame (the JAX
formula), and (d) the least work of each kernel's function at those
peaks, the bound ``chip_smoke.py`` sets beside each kernel's time.
These bounds do not depend on how a kernel is written; the calibrated,
design-dependent bound is ``utils/kernel_model.py``'s.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

# One H100 SXM (NVIDIA's data sheet, at the full 700 W): fp32 outside the
# tensor cores and the HBM3 rate, the two rates a kernel's least work is
# priced at.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12

# Published peaks by the name torch.cuda.get_device_name() gives.
DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bw": PEAK_BYTES, "fp32_flops": PEAK_FLOPS},
}


def device_specs(device: Union[None, int, str, torch.device] = None,
                 name: Optional[str] = None) -> Dict[str, float]:
    """Published peaks of ``device`` (default: the current card), or of the
    card called ``name``.  An unknown card raises ``ValueError``: no card
    borrows another's peaks."""
    if name is None:
        if torch.device(device if device is not None else "cuda").type \
                != "cuda":
            raise ValueError(f"no published peaks for device {device!r}: "
                             f"peaks are a CUDA card's")
        name = torch.cuda.get_device_name(device)
    if name not in DEVICE_SPECS:
        raise ValueError(f"no published peaks for the card {name!r} (known: "
                         f"{', '.join(DEVICE_SPECS)})")
    return dict(DEVICE_SPECS[name])


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record host and device activity: ``with trace('/tmp/trace'):
    run()`` writes ``/tmp/trace/trace.json``, a Chrome trace (Perfetto or
    chrome://tracing).  Yields the profiler, for ``key_averages()``."""
    import os

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# What :func:`span` returns while no profiler records: one shared no-op.
_NO_SPAN = contextlib.nullcontext()

# What ran, by name: each kernel launch under the name of its span
# (``K1`` ... ``K11c``, ``K8b``, ``K8h``, ``K8hb``, ``large_k.<step>``;
# ``ops._build.launch`` counts it once it succeeded), each call of a plain
# twin as ``plain.<function>``, each call of a large-k route as
# ``route.<K>`` and each K10a launch also as ``K10a.<mode>``.  A check
# copies it, runs, and compares ``COUNTS - before`` with what it expects.
COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A range named ``name`` in the profiler's trace, for a ``with``
    block: ``torch.profiler.record_function(name)`` while a torch profiler
    records on this thread (the autograd engine's threads inherit its
    state), else one shared ``nullcontext``, so that a span costs one C
    call when nothing is traced.  The range is a host event on the same
    clock as the device's, so a kernel launched inside it belongs to it.

    The port's spans are named ``custereo.<layer>.<what>``: ``kernel.<K>``
    around each launch (``ops._build.launch``), ``model.disparity_maps``,
    ``model.pyramid`` and inside it the pyramid's glue, ``pyramid.pool``,
    ``pyramid.warp`` and ``pyramid.compose`` (around K11p, K11w and K11c
    on the ``cuda`` backend), ``train.step``,
    ``train.loss`` and ``vjp.allpairs``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def zncc_roofline(H: int, W: int, D: int, k: int, *,
                  materialize_volume: bool,
                  device: Union[None, int, str, torch.device] = None,
                  spec: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
    """Roofline model of one ZNCC frame (the JAX package's formula).

    Memory leg: read both images, plus write the banded volume when it is
    materialized; the fused pipeline writes four maps.  Compute leg: ~2·2k
    adds per output element for the windowed cross term plus ~10
    elementwise ops (and ~2 transcendentals in the fused head, at 4 ops
    each).  ``spec`` (``hbm_bw``, ``fp32_flops``) defaults to the card's
    published peaks."""
    spec = spec if spec is not None else device_specs(device)
    elems = H * W * (D + 1)
    image_bytes = 2 * H * W * 4
    if materialize_volume:
        bytes_moved = image_bytes + elems * 4
        ops = elems * (4 * k + 10)
    else:
        bytes_moved = image_bytes + 4 * H * W * 4
        ops = elems * (4 * k + 10 + 2 * 4)
    t_mem = bytes_moved / spec["hbm_bw"]
    t_compute = ops / spec["fp32_flops"]
    t_bound = max(t_mem, t_compute)
    return {
        "t_memory_s": t_mem,
        "t_compute_s": t_compute,
        "bound_s": t_bound,
        "bound_fps": 1.0 / t_bound,
        "bound_by": "memory" if t_mem >= t_compute else "compute",
        "bytes_moved": float(bytes_moved),
        "vector_ops": float(ops),
    }


# ---------------------------------------------------------------------------
# Least-work bounds at the published peaks
# ---------------------------------------------------------------------------

def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(ms, what bounds it): the least time for ``flops`` fp32 operations
    and ``nbytes`` moved, each input read once and each output written
    once, at the data sheet's peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


# The least fp32 operations of one volume entry (one pixel and plane, or
# one pixel and projector column for K8), with every k x k window sum
# taken separably (k column taps, then k row taps), as the least work the
# functions need rather than what any kernel does:
def cost_flops(k: int) -> int:
    # one product, the window's 2k taps, then (sxy - mux sy + eps) r with
    # r = rsqrt(ex2 ey2 + eps): 7
    return 2 * k + 8


HEAD_FLOPS = 6       # max, argmax, e^{beta c}, s += u, t += d u
COTANGENT_FLOPS = 8  # g_d from the head's maps (pallas_pipeline.py:979-990)


def vjp_flops(k: int) -> int:
    # gr = g r, the window of gr (2k taps), A1 += box proj, the B and GRMU
    # sums: 2k + 9 (r itself is cost_flops' or, with the cost read, 3 more)
    return 2 * k + 9


def banded_bounds(B: int, H: int, W: int, D: int, k: int) -> dict:
    """Each banded kernel's bound at [B, H, W], D, k: operations from the
    per-entry counts above; bytes count the images, maps and volumes each
    kernel reads and writes, 4 a value."""
    n = B * H * W * (D + 1)        # volume entries
    px = 4 * B * H * W             # bytes of one [B, H, W] map
    vol = 4 * n                    # bytes of one volume
    fwd = (cost_flops(k) + HEAD_FLOPS) * n
    with_cost = (3 + vjp_flops(k)) * n
    recompute = (cost_flops(k) + vjp_flops(k)) * n
    return {
        "K1": bound(cost_flops(k) * n, vol + 2 * px),        # images; volume
        "K3": bound(fwd, 6 * px),                            # images; 4 maps
        "K3w": bound(fwd, vol + 9 * px),                     # + am, s, t
        "K3m": bound(fwd, 9 * px),
        "K2": bound(with_cost, 2 * vol + 3 * px),            # g, cost; grad
        "K7": bound(with_cost, 2 * vol + 3 * px),
        "K4": bound(with_cost + COTANGENT_FLOPS * n,         # cost, 7 maps;
                    vol + 10 * px),                          # grad
        "K5": bound(recompute + COTANGENT_FLOPS * n, 10 * px),
        "K6": bound(recompute, vol + 3 * px),                # g, images; grad
        "K9a": bound(0, 2 * vol),
        "K9b": bound(0, 2 * vol),
    }


def allpairs_bound(B: int, H: int, W: int, k: int) -> Tuple[float, str]:
    """K8's bound at [B, H, W], k: an entry per pixel and projector column
    (``cost_flops``); the images in, the [B, H, W, W] volume out."""
    n = B * H * W * W
    return bound(cost_flops(k) * n, 4 * n + 2 * 4 * B * H * W)


__all__ = ["COTANGENT_FLOPS", "COUNTS", "DEVICE_SPECS", "HEAD_FLOPS", "PEAK_BYTES",
           "PEAK_FLOPS", "allpairs_bound", "banded_bounds", "bound",
           "card_line", "cost_flops", "device_specs", "span", "trace",
           "vjp_flops", "zncc_roofline"]
