"""Calibrated bound model of the port's Hopper kernels.

The counterpart of ``custereomatching_tpu/utils/kernel_model.py``, with
its public names.  A kernel's bound is the larger of two legs:

1. **Compute**: the count of each class of work the kernel does (mirrored
   from its CUDA source, ``csrc/``), each priced at the rate this card
   sustains for that class, summed.  The rates come from probes K10a-c
   (``csrc/rate_probes.cu``), measured once per card and cached
   (:func:`measure_vpu_rates`).  Nothing is calibrated against the kernels
   themselves.
2. **Memory**: the bytes the kernel moves through HBM (``bytes_r`` read,
   ``bytes_w`` written, scratch maps included), at the rates of the HBM
   probes, which read and write a KITTI-sized volume with the card's bulk
   copies (K10b a ring of ``cp.async.bulk`` copies issued ahead of the
   threads that sum, K10c a dense stream of 16-byte stores): the most this
   card gives a kernel for those bytes, whatever pattern the kernel's own
   loads and stores follow.  A traffic without the read/write split (the
   all-pairs VJP's floor, the large-k route's launches) counts ``bytes``
   only, priced at the data sheet's bandwidth.

The classes, as one thread's instructions (a "warp-wide" op is 32 of
them):

``madd``
    one FP32 FMA-pipe instruction (FFMA, FADD, FMUL, a compare or a
    select) not already counted with a load.  Probe: eight independent
    FMA chains a thread.
``smem``
    one shared-memory load or store, or one global load served by the
    L1/L2 caches (the same load pipe), with the arithmetic instruction
    that consumes it.  Probe: FMA chains each fed by a shared load at an
    offset that moves every iteration (the Hopper counterpart of the TPU's
    ``lshift``/``sshift`` relayouts: a window sum's neighbour reads).
``exp``, ``rsqrt``
    one ``expf``; one ``rsqrtf`` (and, priced the same, one ``sqrtf`` or
    IEEE division: the multi-function unit and a few fix-up instructions).
    Probes: chains of ``expf(a * 0.25)`` and ``rsqrtf(a + 1)``.
``boxadd``
    one shared-memory load inside K1's first per-plane window pass (a
    rows pass of products: two loads a tap; a rows pass of sums: one; a
    columns tap: one), the pass's barriers included.  Probe: that pass, at
    its geometry and occupancy; normalised by :func:`box_pass_loads`.  A
    rate class of the JAX bound model too; it prices no kernel of the
    port: every kernel runs the register-blocked pass
    (:func:`window_pass_cost`, K1-K7) or K8's register tiles, priced in
    ``smem`` or ``madd``.

Rate keys: the classes (seconds an element), ``hbm_r3d`` and ``hbm_w3d``
(seconds a byte, K10b and K10c; cached with the probes' design,
``HBM_PROBE``), ``t3d`` and ``dus3d`` (seconds a byte
read and written of the plain-torch volume ops of the parity adapter,
``permute().contiguous()`` and zeros plus a copy into plane-major).

Like the JAX module, each cost function returns an :class:`OpCount`;
:func:`kernel_bound` prices it.  The count is a floor: where a kernel's
instructions are uncertain, fewer are counted, so the bound cannot pass
the kernel's time.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.utils.profiling import COUNTS

CACHE_PATH = (Path(__file__).resolve().parents[2] / "build" / "rates"
              / "hopper_rates.json")

_OP_MODES = ("madd", "smem", "exp", "rsqrt", "boxadd")
_DMA_MODES = ("hbm_r3d", "hbm_w3d")
_TORCH_MODES = ("t3d", "dus3d")
_ALL_MODES = _OP_MODES + _DMA_MODES + _TORCH_MODES

# Python mirrors of the kernels' geometry (csrc/common.cuh kTileH, kTileW;
# csrc/rate_probes.cu kRateThreads, kChains, kUnroll, kBoxK, kBoxD).
K_TILE_H, K_TILE_W = 16, 64
K_THREADS = K_TILE_H * K_TILE_W
# The tile heights the rounds kernels of K1, K3 (K3w, K3m) and K4 are built
# at (csrc/common.cuh Tile): TH rows of K_THREADS // TH columns.
TILE_ROWS = (8, 16, 32)
RATE_THREADS, RATE_CHAINS, RATE_UNROLL = 256, 8, 8
BOX_PROBE_K, BOX_PROBE_D = 15, 192
# The shared memory a block may opt into on an H100 (227 KB): the default
# budget of the geometry below.  The wrappers pass their card's own
# (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, which the launchers read).
SMEM_OPTIN_BYTES = 232448
# The register-blocked window pass: outputs a work item of K3's rows pass
# and column sums (csrc/common.cuh kRoundRows, kRoundCols); of K5's
# cross-term rows pass and its column sums, the halo entries a K5 thread
# owns and the constants staged an entry (csrc/fused_pipeline_bwd.cu
# kHaloRows, kHaloCols, kHaloOwn, kHaloConsts); of gr's rows pass and
# column sums (K4, K5, K6) and the most planes a round of K4 and K6 takes
# (csrc/camera_grad.cuh kGradRows, kGradCols, kGradPlanes).
ROUND_ROWS, ROUND_COLS = 16, 16
HALO_ROWS, HALO_COLS, HALO_OWN, HALO_CONSTS = 15, 13, 4, 8
GRAD_ROWS, GRAD_COLS, GRAD_PLANES = 8, 8, 8
# The planes of a slab of the chunked route of K5 and K6
# (csrc/camera_grad.cuh kCostChunk).
COST_CHUNK = 8
# K9a (csrc/layout.cu kParityPixels, kParityThreads, kParityChunk): a
# block's run of pixels, its threads, and the most planes it stages.
PARITY_PIXELS, PARITY_THREADS, PARITY_CHUNK = 64, 512, 256
# K8 (csrc/zncc_allpairs.cu kApWarps, kApXPerThread, kApYPerThread,
# kApRows): a block's warps, a thread's camera and projector columns, and
# the output rows of a block's strip.
AP_WARPS, AP_X_PER_THREAD, AP_Y_PER_THREAD, AP_ROWS = 4, 4, 2, 16
AP_TILE_X, AP_TILE_Y = AP_WARPS * AP_X_PER_THREAD, 32 * AP_Y_PER_THREAD
# K8b (csrc/zncc_allpairs_bwd.cu kGbThreads, kGbTileX, kGbRows, kGbTaps,
# kGbTapChunk): a block's threads, its camera columns (the projector
# columns of a chunk: a thread each), the output rows of a strip, the taps
# of an E unit and the most taps a walk over the columns.
GB_THREADS, GB_TILE_X, GB_ROWS, GB_TAPS, GB_TAP_CHUNK = 256, 4, 16, 8, 128
GB_CHUNK_W, GB_PAIRS = GB_THREADS // GB_TILE_X, GB_ROWS * GB_TILE_X
GB_SPLITS = GB_CHUNK_W // 32
# The large-k route's window sums (csrc/large_k.cu kBoxOut, kBoxGroups,
# kBoxSpan; kRpWarps, kRpXPer, kRpYPer, kRpTaps): box_axis's outputs a
# thread, groups a block (a block's tile of lines is LK_BOX_TILE long) and
# staged entries of a line a chunk; row_products' warps, a thread's
# camera and projector columns, and taps a chunk.
LK_BOX_OUT, LK_BOX_GROUPS = 16, 8
LK_BOX_TILE = LK_BOX_OUT * LK_BOX_GROUPS
LK_BOX_SPAN = LK_BOX_TILE + 255
LK_RP_WARPS, LK_RP_X_PER, LK_RP_Y_PER, LK_RP_TAPS = 2, 8, 2, 256
LK_RP_THREADS = 32 * LK_RP_WARPS
LK_RP_TILE_X, LK_RP_TILE_Y = LK_RP_WARPS * LK_RP_X_PER, 32 * LK_RP_Y_PER
# An H100 SM issues four warp-wide FP32 instructions a clock for each
# warp-wide shared-memory access (128 FP32 lanes, 32 load/store lanes).
FMA_PER_SMEM = 4

_MODE_IDS = {"madd": 0, "smem": 1, "exp": 2, "rsqrt": 3, "boxadd": 4}
# The probes' fixed inputs: the accumulators' start (_rate_kernel's 0.6),
# the smem probe's shared values (0.015625) and boxadd's staged tiles
# (0.125, so a product is 0.015625).
RATE_A0, SMEM_FILL, BOX_FILL = 0.6, 0.015625, 0.125
# A measuring launch: blocks an SM and iterations, for a launch of >= 1 ms
# on an H100 (JAX's ~2 G element-ops a call would be ~60 us of FMAs).
RATE_BLOCKS_PER_SM = {"madd": 8, "smem": 8, "exp": 8, "rsqrt": 8,
                      "boxadd": 4}
RATE_ITERS = {"madd": 32768, "smem": 8192, "exp": 4096, "rsqrt": 4096,
              "boxadd": 256}
# The HBM probes' volume: KITTI's, P = D + 1 = 193 planes of 375 x 1242.
HBM_SHAPE = (193, 375, 1242)
# Volumes the probes' checks add to it: rows and planes off 16-byte
# boundaries, counts not a multiple of 4; one plane shorter than K10b's
# run of pixels (csrc/rate_probes.cu kReadRun) and one of several runs.
HBM_EDGE_SHAPES = ((5, 7, 13), (9, 37, 131))
# The design of K10b and K10c, stored beside their rates in the cache: a
# cache that holds another (or none) does not price with its hbm_r3d and
# hbm_w3d, which were measured by other probes.
HBM_PROBE = "bulk ring read, 16-byte store write"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the CUDA card, and none is "
                           f"available")


# ---------------------------------------------------------------------------
# K10a-c: the probes, their plain twins and the rates they measure
# ---------------------------------------------------------------------------

def rate_probe_cols(mode: str) -> int:
    """Columns of K10a's output: a row a block, an accumulator a column."""
    return K_THREADS if mode == "boxadd" else RATE_THREADS * RATE_CHAINS


def _box_value() -> torch.Tensor:
    """The window sum of boxadd's staged tiles: a rows pass of k products
    of two ``BOX_FILL`` tiles, then k columns (225 * 0.015625)."""
    k = BOX_PROBE_K
    tile = torch.full((k, k), BOX_FILL, dtype=torch.float32)
    return (tile * tile).sum(0).sum(0)


def _f32(x: float) -> float:
    """``x`` rounded to fp32, the value of the kernels' ``x``f literal."""
    return torch.tensor(x, dtype=torch.float32).item()


def rate_probe_reference(mode: str, iters: int, rows: int, cols: int,
                         device="cpu") -> torch.Tensor:
    """Plain version of K10a: a ``[rows, cols]`` tile at ``RATE_A0``
    through ``iters`` iterations of ``mode``'s op (``_rate_kernel``'s
    function).  The multiply-add is the kernel's ``fmaf``: the product of
    two fp32 values is exact in fp64, and the sum is rounded to fp32 once.
    A product rounded before the add would settle elsewhere: near madd's
    fixed point (0.625) a step moves ``a`` by less than half an fp32 ulp
    within ~1e-4 of it, so each rounding order stops at its own value."""
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown K10a mode {mode!r}")
    COUNTS["plain.rate_probe_reference"] += 1
    a = torch.full((rows, cols), RATE_A0, dtype=torch.float32, device=device)
    mul = _f32(0.9996)
    add = {"madd": _f32(0.00025), "smem": SMEM_FILL}.get(mode)
    if mode == "boxadd":
        add = _box_value().item()
    for _ in range(iters):
        if mode == "exp":
            a = torch.exp(a * 0.25)
        elif mode == "rsqrt":
            a = torch.rsqrt(a + 1.0)
        else:
            a = (a.double() * mul + add).float()
    return a


def rate_probe(mode: str, iters: int, blocks: int,
               device="cuda") -> torch.Tensor:
    """K10a: ``blocks`` blocks of ``mode``'s chains through ``iters``
    iterations; ``[blocks, rate_probe_cols(mode)]``.  On the CPU the plain
    version; on a CUDA device the kernel, or the call raises.  A launch
    counts in ``COUNTS`` as ``K10a`` and as ``K10a.<mode>``."""
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown K10a mode {mode!r}")
    if mode != "boxadd" and iters % RATE_UNROLL:
        raise ValueError(f"K10a {mode}: iters must be a multiple of "
                         f"{RATE_UNROLL}, got {iters}")
    device = torch.device(device)
    if device.type == "cpu":
        return rate_probe_reference(mode, iters, blocks,
                                    rate_probe_cols(mode))
    if device.type != "cuda":
        raise ValueError(f"K10a runs on CUDA or (plain) CPU, got {device}")
    out = torch.empty((blocks, rate_probe_cols(mode)), dtype=torch.float32,
                      device=device)
    fill = BOX_FILL if mode == "boxadd" else SMEM_FILL
    with torch.cuda.device(device):
        _build.launch("K10a", "custereo_rate_probe", _MODE_IDS[mode],
                      _build.ptr(out), blocks, iters, RATE_A0, 0.0, fill,
                      _build.stream_of(device), what=f"K10a {mode} launch")
    COUNTS[f"K10a.{mode}"] += 1
    return out


def _on_card(device: torch.device, kernel: str, entry: str, *args) -> None:
    """``_build.launch(kernel, entry, *args, stream)`` on ``device``'s
    current stream, with ``device`` made current only where it is not: a
    probe times what the card takes, so its launch spends as little host
    time as it can."""
    if device.index is None or device.index == torch.cuda.current_device():
        _build.launch(kernel, entry, *args, _build.stream_of(device))
        return
    with torch.cuda.device(device):
        _build.launch(kernel, entry, *args, _build.stream_of(device))


def _check_volume(vol: torch.Tensor, what: str) -> None:
    if vol.ndim != 3 or vol.dtype != torch.float32 or vol.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty float32 [P, H, W] "
                         f"volume, got {vol.dtype} {tuple(vol.shape)}")


def hbm_read_reference(vol: torch.Tensor) -> torch.Tensor:
    """Plain version of K10b: each pixel's sum over the planes, in plane
    order."""
    COUNTS["plain.hbm_read_reference"] += 1
    acc = torch.zeros(vol.shape[1:], dtype=vol.dtype, device=vol.device)
    for d in range(vol.shape[0]):
        acc = acc + vol[d]
    return acc


def hbm_read_probe(vol: torch.Tensor) -> torch.Tensor:
    """K10b: ``[H, W]`` plane sums of a plane-major ``[P, H, W]`` volume,
    each pixel's planes added in order.  The counterpart of JAX's
    ``_dma_read_kernel``: a block's run of pixels streams through a ring
    of shared-memory stages filled by ``cp.async.bulk`` copies issued
    ahead of the threads that sum, so its rate ``hbm_r3d`` is the card's
    bulk read rate for the volume.  On the CPU the plain version; on a
    CUDA device the kernel, or the call raises."""
    _check_volume(vol, "K10b")
    device = vol.device
    if device.type == "cpu":
        return hbm_read_reference(vol)
    if device.type != "cuda":
        raise ValueError(f"K10b runs on CUDA or (plain) CPU tensors, got "
                         f"{device}")
    vol = vol.contiguous()
    P, H, W = vol.shape
    out = vol.new_empty((H, W))
    _on_card(device, "K10b", "custereo_hbm_read_probe", vol.data_ptr(),
             out.data_ptr(), P, H, W)
    return out


def hbm_write_reference(P: int, H: int, W: int, device="cpu") -> torch.Tensor:
    """Plain version of K10c: ``out[d, h, w] = d``, a plane at a time."""
    COUNTS["plain.hbm_write_reference"] += 1
    out = torch.empty((P, H, W), dtype=torch.float32, device=device)
    for d in range(P):
        out[d].fill_(float(d))
    return out


def hbm_write_probe(P: int, H: int, W: int, device="cuda") -> torch.Tensor:
    """K10c: a new ``[P, H, W]`` volume with ``out[d, h, w] = d``.  The
    counterpart of JAX's ``_dma_write_kernel``: the flat volume written as
    one dense stream, a contiguous span a block and 16 bytes a store, so
    its rate ``hbm_w3d`` is the card's bulk write rate for the volume.  On
    the CPU the plain version; on a CUDA device the kernel, or the call
    raises."""
    if min(P, H, W) < 1:
        raise ValueError(f"K10c: expected a non-empty [P, H, W] volume, got "
                         f"[{P}, {H}, {W}]")
    device = torch.device(device)
    if device.type == "cpu":
        return hbm_write_reference(P, H, W)
    if device.type != "cuda":
        raise ValueError(f"K10c runs on CUDA or (plain) CPU, got {device}")
    out = torch.empty((P, H, W), dtype=torch.float32, device=device)
    _on_card(device, "K10c", "custereo_hbm_write_probe", out.data_ptr(), P,
             H, W)
    return out


def rate_probe_size(mode: str) -> Tuple[int, int]:
    """(blocks, iters) of ``mode``'s measuring launch on the current card."""
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return RATE_BLOCKS_PER_SM[mode] * sms, RATE_ITERS[mode]


def rate_probe_elems(mode: str, blocks: int, iters: int) -> float:
    """The elements a K10a launch is normalised by: tile elements times
    iterations, or for boxadd the loads of its passes
    (:func:`box_pass_loads`)."""
    if mode == "boxadd":
        p = BOX_PROBE_K // 2
        return float(blocks * iters * box_pass_loads(
            BOX_PROBE_K, K_TILE_H, K_TILE_W + 2 * p, K_THREADS))
    return float(blocks * rate_probe_cols(mode) * iters)


def _device_seconds(fn, *args, chain: int = 2) -> float:
    from custereomatching_tpu_torch.utils.timer import benchmark

    return benchmark(fn, *args, warmup=1, iters=5, chain=chain)["median_s"]


def _run_rate(mode: str) -> float:
    """Seconds an element of one op class (K10a at its measuring size)."""
    _need_card("K10a")
    blocks, iters = rate_probe_size(mode)
    t = _device_seconds(rate_probe, mode, iters, blocks, "cuda")
    return t / rate_probe_elems(mode, blocks, iters)


def _run_dma_rate(mode: str) -> float:
    """Seconds a byte of the card's bulk HBM read or write (K10b or K10c
    at KITTI's volume)."""
    _need_card("K10b/K10c")
    P, H, W = HBM_SHAPE
    if mode == "hbm_r3d":
        vol = torch.ones(HBM_SHAPE, dtype=torch.float32, device="cuda")
        t = _device_seconds(hbm_read_probe, vol, chain=8)
    elif mode == "hbm_w3d":
        t = _device_seconds(hbm_write_probe, P, H, W, "cuda", chain=8)
    else:
        raise ValueError(mode)
    return t / (P * H * W * 4)


def _run_torch_rate(mode: str) -> float:
    """Seconds a byte (read and written) of a plain-torch volume op at
    KITTI's volume: ``t3d`` the plane-major volume to parity,
    ``permute().contiguous()``; ``dus3d`` a parity cotangent into a zeroed
    plane-major volume.  Plain torch, as the JAX counterpart is plain
    XLA."""
    _need_card("the torch volume-op rates")
    P, H, W = HBM_SHAPE
    if mode == "t3d":
        src = torch.ones((P, H, W), dtype=torch.float32, device="cuda")

        def fn(v):
            return v.permute(1, 2, 0).contiguous()
    elif mode == "dus3d":
        src = torch.ones((H, W, P), dtype=torch.float32, device="cuda")

        def fn(g):
            return torch.zeros((P, H, W), dtype=g.dtype,
                               device=g.device).copy_(g.permute(2, 0, 1))
    else:
        raise ValueError(mode)
    return _device_seconds(fn, src, chain=4) / (2 * P * H * W * 4)


def _card_name() -> str:
    _need_card("measure_vpu_rates")
    return torch.cuda.get_device_name()


def _median_rounds(fn, modes, rounds: int = 3) -> Dict[str, float]:
    runs = [{m: fn(m) for m in modes} for _ in range(rounds)]
    return {m: sorted(r[m] for r in runs)[rounds // 2] for m in modes}


def _measure(modes) -> Dict[str, float]:
    rates = {}
    for group, fn in ((_OP_MODES, _run_rate), (_DMA_MODES, _run_dma_rate),
                      (_TORCH_MODES, _run_torch_rate)):
        todo = [m for m in group if m in modes]
        if todo:
            rates.update(_median_rounds(fn, todo))
    return rates


def measure_vpu_rates(force: bool = False,
                      cache_path: Optional[str] = None,
                      measure_if_missing: bool = True,
                      device_name: Optional[str] = None,
                      ) -> Optional[Dict[str, float]]:
    """Per-class rates of this card (seconds an element, or a byte).

    Cached on disk by card name (``build/rates/hopper_rates.json``, git
    ignored; never the JAX package's ``vpu_rates.json``), each entry with
    the power limit ``nvidia-smi`` reported and the HBM probes' design
    (``HBM_PROBE``).  Measured in three rounds, the median of each class.
    A partial cache is topped up; ``hbm_r3d`` and ``hbm_w3d`` cached
    beside another design, or none, count as missing.  With
    ``measure_if_missing=False`` a miss returns what the cache has, or
    ``None``.  ``device_name`` names the card instead of asking torch.
    Without a card, a call that would measure raises ``RuntimeError``."""
    kind = device_name or _card_name()
    path = Path(cache_path) if cache_path else CACHE_PATH
    cache = {}
    if path.is_file():
        try:
            cache = json.loads(path.read_text())
        except (OSError, ValueError):
            cache = {}
    entry = cache.get(kind, {})
    stale = () if entry.get("hbm_probe") == HBM_PROBE else _DMA_MODES
    have = {m: float(v) for m, v in entry.items()
            if m in _ALL_MODES and m not in stale}
    missing = [m for m in _ALL_MODES if m not in have]
    if not force and kind in cache and not missing:
        return have
    if not measure_if_missing and not force:
        # A partial cache still prices every kernel that does not use the
        # missing classes; without HBM rates the memory leg falls back to
        # the data sheet's bandwidth.
        return have if kind in cache else None
    _need_card("measure_vpu_rates")
    from custereomatching_tpu_torch.utils.profiling import card_line

    rates = _measure(_ALL_MODES if force else missing)
    if not force:
        rates = {**have, **rates}
    cache[kind] = {**rates, "hbm_probe": HBM_PROBE,
                   "power_limit": card_line().rsplit(",", 1)[-1].strip()}
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(cache, indent=1, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass
    return dict(rates)


# ---------------------------------------------------------------------------
# Structural counting
# ---------------------------------------------------------------------------

class OpCount(dict):
    """Per-class element counts; supports ``+`` and ``scaled``."""

    def __init__(self, **kw):
        super().__init__({m: 0.0 for m in _OP_MODES})
        self.update({k: float(v) for k, v in kw.items()})
        self.bytes = 0.0
        # The read/write split of ``bytes``; when populated (and the rates
        # carry the HBM probes'), the memory leg is priced per pattern.
        self.bytes_r = 0.0
        self.bytes_w = 0.0

    def __add__(self, other):
        out = OpCount()
        for m in _OP_MODES:
            out[m] = self[m] + other[m]
        out.bytes = self.bytes + getattr(other, "bytes", 0.0)
        out.bytes_r = self.bytes_r + getattr(other, "bytes_r", 0.0)
        out.bytes_w = self.bytes_w + getattr(other, "bytes_w", 0.0)
        return out

    def scaled(self, f):
        out = OpCount()
        for m in _OP_MODES:
            out[m] = self[m] * f
        out.bytes = self.bytes * f
        out.bytes_r = self.bytes_r * f
        out.bytes_w = self.bytes_w * f
        return out

    def time(self, rates: Dict[str, float], hbm_bw: float) -> Dict:
        # Zero-count classes are skipped, so a partial rate cache still
        # prices every kernel that does not use the missing classes.
        by_class = {m: self[m] * rates[m] for m in _OP_MODES if self[m]}
        t_c = sum(by_class.values())
        if (self.bytes_r + self.bytes_w > 0
                and all(m in rates for m in _DMA_MODES)):
            t_m = (self.bytes_r * rates["hbm_r3d"]
                   + self.bytes_w * rates["hbm_w3d"])
        else:
            t_m = self.bytes / hbm_bw
        return {"t_compute_s": t_c, "t_memory_s": t_m,
                "bound_s": max(t_c, t_m),
                "bound_by": "compute" if t_c >= t_m else "memory",
                "by_class": by_class}


def _with_bytes(c: OpCount, bytes_r: float, bytes_w: float) -> OpCount:
    c.bytes_r, c.bytes_w = float(bytes_r), float(bytes_w)
    c.bytes = c.bytes_r + c.bytes_w
    return c


def box_pass_loads(k: int, rows: int, width: int, pixels: int) -> int:
    """Shared loads of one per-plane window pass of a block: a rows pass
    of products over ``rows`` x ``width`` entries of k taps (two loads a
    tap, ``vertical_products``), then k column taps (``horizontal_sum``)
    for each of ``pixels`` outputs.  The ``boxadd`` element."""
    return rows * width * k * 2 + pixels * k


def _overlap(n_tiles: int, tile: int, ext: int, lo: int, hi: int) -> int:
    """Sum over tiles i of |[i tile - ext, (i + 1) tile + ext) ∩ [lo, hi)|."""
    total = 0
    for i in range(n_tiles):
        a, b = max(i * tile - ext, lo), min((i + 1) * tile + ext, hi)
        total += max(b - a, 0)
    return total


def tile_cols(tile_rows: int) -> int:
    """Columns of a tile of ``tile_rows`` rows (``Tile<TH>::kW``)."""
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {TILE_ROWS}, got "
                         f"{tile_rows!r}")
    return K_THREADS // tile_rows


def _grid(H: int, W: int, tile_rows: int = K_TILE_H) -> Tuple[int, int]:
    """(row tiles, column tiles) of the pixel tiling (16 x 64 by
    default)."""
    return _cdiv(H, tile_rows), _cdiv(W, tile_cols(tile_rows))


def _stats_cost(H: int, W: int, k: int, wout: int) -> OpCount:
    """``box_stats_kernel`` (common.cuh) for one image, outputs ``wout``
    columns wide: the halo'd tile staged (a load and a store an entry),
    the rows pass of x and x^2 (a load, an add and an FMA a tap), the two
    column sums of each pixel, two maps written."""
    p = k // 2
    nbh, nbw = _cdiv(H, K_TILE_H), _cdiv(wout, K_TILE_W)
    blocks = nbh * nbw
    cols = K_TILE_W + 2 * p
    halo = (K_TILE_H + 2 * p) * cols
    vert = K_TILE_H * cols * k
    px = H * wout
    c = OpCount(smem=blocks * (2 * halo + vert) + px * 2 * k,
                madd=blocks * vert + 3 * px)
    return _with_bytes(c, H * W * 4, 2 * px * 4)


def _combine_cost(H: int, W: int, k: int, we: int) -> OpCount:
    """The combine kernel of K2/K4/K5/K6 (``camera_grad_combine_kernel``)
    or K7 (``proj_grad_combine_kernel``, three maps ``we`` columns wide):
    three halo'd tiles staged, three box filters, the final sum."""
    p = k // 2
    nbh, nbw = _grid(H, W)
    cols = K_TILE_W + 2 * p
    halo = (K_TILE_H + 2 * p) * cols
    inside = (_overlap(nbh, K_TILE_H, p, 0, H)
              * _overlap(nbw, K_TILE_W, p, 0, we))
    outside = nbh * nbw * halo - inside
    return OpCount(smem=6 * inside + 3 * outside
                   + nbh * nbw * 3 * K_TILE_H * cols * k + H * W * 3 * k,
                   madd=2 * inside + 4 * H * W)


def window_pass_cost(items: int, n: int, k: int,
                     products: bool) -> OpCount:
    """``items`` work items of the register-blocked pass (common.cuh
    ``window_taps``): each makes ``n`` outputs of ``k`` taps from
    ``n + k - 1`` loads of each operand (two for products), stores them,
    and issues ``n k`` FMAs or adds.  The loads and the FMAs go to two
    pipes that run side by side, so only the one that binds is counted:
    the shared accesses in ``smem``, or the FMAs in ``madd``, whichever
    takes more issue slots at ``FMA_PER_SMEM`` FMAs an access."""
    access = (n + k - 1) * (2 if products else 1) + n
    ops = n * k
    if access * FMA_PER_SMEM >= ops:
        return OpCount(smem=items * access)
    return OpCount(madd=items * ops)


def _round_floats(k: int, chunk: int,
                  tile_rows: int = K_TILE_H) -> Tuple[int, int]:
    """K1's and K3's block in floats (``RoundTile`` of common.cuh) at a
    tile of ``tile_rows`` rows: the camera tile and a projector tile of
    ``chunk`` planes, and the rows-pass and window-sum buffers of one plane
    (rows padded to an odd stride)."""
    p, tw = k // 2, tile_cols(tile_rows)
    rows, cam_w = tile_rows + 2 * p, tw + 2 * p
    return (rows * (2 * cam_w + chunk - 1),
            tile_rows * (cam_w + 1) + tile_rows * (tw + 1))


def _whole_rounds(planes: int, chunk: int, D: int) -> Tuple[int, int]:
    """``whole_rounds`` of common.cuh: a chunk short of D + 1 cut to a
    whole number of rounds, or the round cut to the chunk."""
    if chunk < D + 1:
        if chunk < planes:
            planes = chunk
        else:
            chunk -= chunk % planes
    return planes, chunk


def _budget(budget: Optional[int]) -> int:
    """A block's shared-memory budget in floats: ``budget``, or an
    H100's."""
    return SMEM_OPTIN_BYTES // 4 if budget is None else int(budget)


def round_planes(k: int, D: int, budget: Optional[int] = None,
                 tile_rows: int = K_TILE_H, planes: int = 0) -> int:
    """The planes a round of K1 and K3 ask for before the projector's
    staging is cut to whole rounds (``fused_round`` of common.cuh): as
    many as give every thread one rows-pass column, fewer where they do
    not fit beside the camera tile and a one-plane projector tile, at most
    D + 1; ``planes`` > 0 asks for that many instead (at most D + 1), and
    gets 0 where they do not fit.  0 when not one plane fits."""
    fixed, per = _round_floats(k, 1, tile_rows)
    budget = _budget(budget)
    if fixed + per > budget:
        return 0
    cam_w = tile_cols(tile_rows) + 2 * (k // 2)
    want = min(max(1, planes if planes > 0 else K_THREADS // cam_w), D + 1)
    fit = (budget - fixed) // per
    if want > fit:
        return 0 if planes > 0 else fit
    return want


def fused_round(k: int, D: int, budget: Optional[int] = None,
                tile_rows: int = K_TILE_H,
                planes: int = 0) -> Tuple[int, int]:
    """(planes a round, planes a projector staging) of K1 and K3
    (``fused_round`` of common.cuh on an H100) at a tile of ``tile_rows``
    rows: :func:`round_planes` (``planes`` > 0 asks for that many), then
    the staging takes what is left, D + 1 or a multiple of the round.
    (0, 0) when not one plane (or not ``planes``) fits.  ``budget``:
    floats a block may hold (an H100's by default)."""
    P = round_planes(k, D, budget, tile_rows, planes)
    if P < 1:
        return 0, 0
    fixed, per = _round_floats(k, 1, tile_rows)
    rows = tile_rows + 2 * (k // 2)
    chunk = min((_budget(budget) - fixed - P * per) // rows + 1, D + 1)
    return _whole_rounds(P, chunk, D)


def fused_block_floats(k: int, D: int, budget: Optional[int] = None,
                       tile_rows: int = K_TILE_H, planes: int = 0) -> int:
    """Shared memory of a K1 or K3 block in floats (``RoundTile::floats``
    at :func:`fused_round`'s planes and chunk)."""
    P, chunk = fused_round(k, D, budget, tile_rows, planes)
    fixed, per = _round_floats(k, chunk, tile_rows)
    return fixed + P * per


def halo_tile(k: int, chunk: int, planes: int) -> Dict[str, int]:
    """K5's shared-memory geometry (``HaloTile`` of
    fused_pipeline_bwd.cu), ``floats`` its block's total."""
    p = k // 2
    t = {"p": p, "halo_rows": K_TILE_H + 2 * p,
         "halo_cols": K_TILE_W + 2 * p, "img_rows": K_TILE_H + 4 * p,
         "img_w": K_TILE_W + 4 * p}
    t["halo"] = t["halo_rows"] * t["halo_cols"]
    t["proj_w"] = t["img_w"] + chunk - 1
    t["xsz"] = max(t["halo_rows"] * (t["img_w"] + 1),
                   K_TILE_H * (t["halo_cols"] + 1))
    t["ysz"] = max(t["halo_rows"] * (t["halo_cols"] + 1),
                   K_TILE_H * (K_TILE_W + 1))
    t["row_groups"] = _cdiv(t["halo_rows"], HALO_ROWS)
    t["fixed"] = HALO_CONSTS * t["halo"] + t["img_rows"] * t["img_w"]
    t["floats"] = (t["fixed"] + t["img_rows"] * t["proj_w"]
                   + planes * (t["xsz"] + t["ysz"]))
    return t


def halo_round(k: int, D: int,
               budget: Optional[int] = None) -> Tuple[int, int]:
    """(planes a round, planes a projector staging) of K5
    (``halo_round`` of fused_pipeline_bwd.cu, within ``budget`` floats, an
    H100's by default); (0, 0) when not one plane fits."""
    t = halo_tile(k, 1, 1)
    budget = _budget(budget)
    proj1 = t["img_rows"] * t["img_w"]
    per = t["xsz"] + t["ysz"]
    if t["fixed"] + proj1 + per > budget:
        return 0, 0
    planes = min(max(1, K_THREADS // (t["img_w"] * t["row_groups"])), D + 1)
    if t["fixed"] + proj1 + planes * per > budget:
        planes = (budget - t["fixed"] - proj1) // per
    one = t["fixed"] + planes * per + proj1
    chunk = min((budget - one) // t["img_rows"] + 1, D + 1)
    return _whole_rounds(planes, chunk, D)


def _fused_rounds(H: int, W: int, k: int, lo: int, hi: int, what: str,
                  tile_rows: int = K_TILE_H, want: int = 0) -> OpCount:
    """One launch of K1's and K3's rounds kernel (fused_pipeline.cuh) over
    the planes lo..hi: a block a tile (16 x 64 by default, ``tile_rows``
    rows of :func:`tile_cols` columns) staging the camera tile once and
    the projector tile once a chunk (:func:`fused_round` for the planes,
    ``want`` of them where > 0; a load and a store an entry); per plane
    the register-blocked rows pass (an item a tile column of
    ``tile_rows`` outputs) and column sums (an item ``ROUND_COLS`` pixels
    of a row); each pixel's mux and ex2 read once, and per plane its
    window sum read back and its two statistics loads."""
    p, tw = k // 2, tile_cols(tile_rows)
    nbh, nbw = _grid(H, W, tile_rows)
    blocks = nbh * nbw
    rows, cam_w = tile_rows + 2 * p, tw + 2 * p
    px, planes = H * W, hi - lo + 1
    P, chunk = fused_round(k, hi - lo, None, tile_rows, want)
    if P < 1:
        raise ValueError(f"{what} takes no k = {k} block of {tile_rows} "
                         f"rows{f' and {want} planes' if want else ''} on "
                         f"an H100")
    stagings = _cdiv(planes, chunk)
    c = window_pass_cost(blocks * cam_w * planes, tile_rows, k, True)
    c = c + window_pass_cost(
        blocks * tile_rows * (tw // ROUND_COLS) * planes, ROUND_COLS,
        k, False)
    return c + OpCount(
        smem=blocks * 2 * rows * (cam_w + stagings * (cam_w + chunk - 1))
        + 2 * px + planes * 3 * px)


def _fused_round_cost(H: int, W: int, D: int, k: int, what: str,
                      tile_rows: int = K_TILE_H, planes: int = 0) -> OpCount:
    """The part K1 and K3 share: the statistics passes and the rounds over
    d = 0..D (:func:`_fused_rounds`, at a tile of ``tile_rows`` rows and
    ``planes`` a round where > 0)."""
    return (_stats_cost(H, W, k, W) + _stats_cost(H, W, k, W + D)
            + _fused_rounds(H, W, k, 0, D, what, tile_rows, planes))


def volume_forward_cost(H: int, W: int, D: int, k: int,
                        tile_rows: int = K_TILE_H,
                        planes: int = 0) -> OpCount:
    """K1 (``csrc/zncc_banded.cu``): K3's rounds kernel without the head,
    at beta = 1 (:func:`_fused_round_cost`, at a tile of ``tile_rows``
    rows and ``planes`` a round where > 0); per pixel and plane one
    rsqrt, five FMA-pipe ops and the volume store."""
    px, planes_d = H * W, D + 1
    c = _fused_round_cost(H, W, D, k, "K1", tile_rows, planes) + OpCount(
        rsqrt=planes_d * px, madd=px + planes_d * 5 * px)
    stats = (2 * px + 2 * H * (W + D)) * 4
    return _with_bytes(c, c.bytes_r + stats, c.bytes_w + planes_d * px * 4)


def fused_forward_cost(H: int, W: int, D: int, k: int,
                       write_volume: bool = False,
                       residuals: Optional[bool] = None,
                       tile_rows: int = K_TILE_H,
                       planes: int = 0) -> OpCount:
    """K3 / K3w / K3m (``csrc/fused_pipeline.cu``): the rounds of
    :func:`_fused_round_cost` (at a tile of ``tile_rows`` rows and
    ``planes`` a round where > 0), and the online head in registers (one
    rsqrt, one expf and eight FMA-pipe ops a pixel and plane), four maps
    out; ``residuals`` adds am, s and t (K3m; K3w always), ``write_volume``
    the volume store (K3w)."""
    residuals = write_volume if residuals is None else residuals
    want = planes
    px, planes = H * W, D + 1
    c = _fused_round_cost(H, W, D, k, "K3", tile_rows, want) + OpCount(
        rsqrt=planes * px + px,                  # + t / s once a pixel
        exp=planes * px,
        madd=px + planes * (8 + int(write_volume)) * px + 4 * px)
    maps = 4 + (3 if residuals else 0)
    stats = (2 * px + 2 * H * (W + D)) * 4
    return _with_bytes(
        c, c.bytes_r + stats,
        c.bytes_w + maps * px * 4 + (planes * px * 4 if write_volume else 0))


def stage_op_cost(H: int, W: int, D: int, S: int, k: int,
                  beta: float = 50.0) -> OpCount:
    """One pipeline stage's op (``parallel/pipeline.py::chunk_state`` on
    the card): K3m (:func:`fused_forward_cost` with the residuals) at
    ``chunk − 1`` disparities over the stage-padded width
    ``W + (D+1) − chunk``, plus the glue, one pass a torch op: the two
    images padded, the projector shifted, ``m = β·conf``, under the
    unnormalized head ``e^{−m}`` and the rescale of
    s and t, and the lift ``am + off``, ``t + off·s``."""
    # Imported here: ops.cuda_pipeline imports this module.
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        unnormalized_head,
    )

    chunk = -(-(D + 1) // S)
    W_pad = W + (D + 1) - chunk
    px, px_pad = H * W, H * W_pad
    c = fused_forward_cost(H, W_pad, chunk - 1, k, residuals=True)
    # pad x2 (read the image, write it padded), shift (read, write).
    r, w = 2 * px + px_pad, 3 * px_pad
    # m = beta conf; am + off; off s; t + off s.
    madd, r, w = 4 * px, r + 5 * px, w + 4 * px
    glue = OpCount(madd=madd)
    if unnormalized_head(beta, chunk - 1):
        # -m, exp, s * scale, t * scale.
        glue = glue + OpCount(madd=3 * px, exp=px)
        r, w = r + 6 * px, w + 4 * px
    return _with_bytes(c + glue, c.bytes_r + 4 * r, c.bytes_w + 4 * w)


def grad_round_tile(k: int, chunk: int, planes: int, *, head: bool,
                    recompute: bool, staged: bool = True,
                    tile_rows: int = K_TILE_H) -> Dict[str, int]:
    """Shared-memory geometry of the rounds kernel of K4 (``head``), K6
    (``recompute``) and K2 and K7 (neither), ``GradRoundTile`` of
    camera_grad.cuh, at a tile of ``tile_rows`` rows (K4's may differ
    from the default 16); ``floats`` its block's total.  Without
    ``staged`` (K4 past k = 47) the entries' constants stay in their
    maps."""
    p = k // 2
    t = {"p": p, "halo_rows": tile_rows + 2 * p,
         "halo_cols": tile_cols(tile_rows) + 2 * p}
    t["halo"] = t["halo_rows"] * t["halo_cols"]
    # ex2 and the source's maps, where staged.
    t["consts"] = (7 if head else 1) if staged else 0
    t["proj_w"] = t["halo_cols"] + chunk - 1
    t["ysz"] = t["halo_rows"] * (t["halo_cols"] + 1)
    t["xsz"] = tile_rows * (t["halo_cols"] + 1)
    t["fixed"] = (t["consts"] + int(recompute)) * t["halo"]
    t["proj"] = t["halo_rows"] * t["proj_w"] if recompute else 0
    t["floats"] = t["fixed"] + t["proj"] + planes * (t["ysz"] + t["xsz"])
    return t


def grad_round(k: int, D: int, head: bool, recompute: bool,
               staged: bool = True, budget: Optional[int] = None,
               tile_rows: int = K_TILE_H) -> Tuple[int, int]:
    """(planes a round, planes a projector staging) of K4 (``head``), K6
    (``recompute``) or K2 and K7 (neither: ex2, or K7's projector ey2, the
    one staged map), the constants ``staged`` or not: ``grad_round`` of
    camera_grad.cuh at a tile of ``tile_rows`` rows within ``budget``
    floats (an H100's by default); (0, 0) when not one plane fits."""
    budget = _budget(budget)
    planes = GRAD_PLANES
    while planes >= 1:
        t = grad_round_tile(k, 1, planes, head=head, recompute=recompute,
                            staged=staged, tile_rows=tile_rows)
        if (planes == 1 or planes <= D + 1) and t["floats"] <= budget:
            if not recompute:
                return planes, D + 1
            one = t["floats"]
            chunk = min((budget - one) // t["halo_rows"] + 1, D + 1)
            if chunk >= D + 1:
                return planes, chunk
            if chunk >= planes:
                return planes, chunk - chunk % planes
        planes //= 2
    return 0, 0


def k4_staged(k: int, D: int, budget: Optional[int] = None,
              tile_rows: int = K_TILE_H) -> bool:
    """Whether K4's rounds kernel stages its entries' constants (a plane's
    buffers fit beside them: k <= 47 on an H100 at the default tile) or
    reads them from their maps (``launch_head_rounds`` of
    head_rounds.cuh)."""
    return grad_round(k, D, True, False, budget=budget,
                      tile_rows=tile_rows)[0] >= 1


def halo_fits(k: int, D: int, budget: Optional[int] = None) -> bool:
    """Whether K5's halo kernel runs (k <= 27 on an H100): one plane a
    round fits and the halo has no more entries than its threads own;
    otherwise K5 takes the chunked route."""
    planes, chunk = halo_round(k, D, budget)
    return planes >= 1 and halo_tile(k, chunk, planes)["halo"] <= (
        HALO_OWN * K_THREADS)


def cost_slab_planes(kernel: str, k: int, D: int,
                     budget: Optional[int] = None) -> int:
    """The planes a frame of the slab that K5's or K6's chunked route
    writes K1's costs into (``launch_cost_slabs`` of camera_grad.cuh):
    ``min(COST_CHUNK, D + 1)`` where the route runs (K5 past its halo
    kernel, K6 past its recomputing block: k > 81 on an H100), else 0 and
    no slab.  The wrappers allocate the slab by it, at their card's
    ``budget``."""
    if kernel == "K5":
        chunked = not halo_fits(k, D, budget)
    elif kernel == "K6":
        chunked = grad_round(k, D, False, True, budget=budget)[0] < 1
    else:
        raise ValueError(f"no chunked route for {kernel}")
    return min(COST_CHUNK, D + 1) if chunked else 0


def cost_slabs(D: int) -> Tuple[Tuple[int, int], ...]:
    """The slabs (lo, hi) of the chunked route: COST_CHUNK planes each,
    the last the rest."""
    return tuple((lo, min(lo + COST_CHUNK - 1, D))
                 for lo in range(0, D + 1, COST_CHUNK))


def _grad_rounds(H: int, W: int, k: int, spans, *, head: bool,
                 recompute: bool, staged: bool, name: str,
                 tile_rows: int = K_TILE_H) -> OpCount:
    """The rounds kernel of ``csrc/camera_grad.cuh``, one launch a span
    (lo, hi) of the planes: over d = 0..D, or each slab of the chunked
    route, which also reads the A1, B and GRMU that the slab before left.

    A round of P planes: (K6) K3's cross-term rows pass and column sums
    over the tile; at every halo entry inside the image its constants
    (seven, or ex2 alone) read once, from shared memory where ``staged``
    (staged once a launch: loaded and stored, 1/s a division), else from
    their maps (eight loads, the division and three products a round);
    for each of the P planes (a short last round computes all P and keeps
    np), ey2 and the cost or cotangent loaded, an rsqrt, gr_d stored (K4
    also the head cotangent: an expf and seven FMA-pipe ops); the tile's
    own pixels also load sy (K2 also the cost, K6 read their window sum
    and form the cost) and add B and GRMU; entries outside store zeros;
    gr's rows pass and column sums; A1 (the box sum and the projector
    read, a select and an FMA) for the round's np planes.  The block's
    tile is ``tile_rows`` rows of :func:`tile_cols` columns (16 x 64 by
    default)."""
    p, th, tw = k // 2, tile_rows, tile_cols(tile_rows)
    nbh, nbw = _grid(H, W, th)
    blocks = nbh * nbw
    px = H * W
    inside = _overlap(nbh, th, p, 0, H) * _overlap(nbw, tw, p, 0, W)
    maps = 6 if head else 0
    c = OpCount()
    for lo, hi in spans:
        planes = hi - lo + 1
        P, chunk = grad_round(k, hi - lo, head, recompute, staged,
                              tile_rows=th)
        if P < 1:
            raise ValueError(f"{name} takes no k = {k}, D = {hi - lo} "
                             f"block of {th} rows on an H100")
        t = grad_round_tile(k, chunk, P, head=head, recompute=recompute,
                            staged=staged, tile_rows=th)
        hc, halo = t["halo_cols"], t["halo"]
        outside = blocks * halo - inside
        rounds = sum(_cdiv(min(chunk, planes - d0), P)
                     for d0 in range(0, planes, chunk))
        slots = rounds * P                   # planes step b computes
        if staged:
            # Prologue: ex2 and the source's maps over the halo.
            c = c + OpCount(smem=(2 + 2 * maps) * inside
                            + (1 + maps) * outside
                            + rounds * t["consts"] * inside,
                            rsqrt=inside if head else 0,
                            madd=(3 * inside if head else 0))
        else:
            c = c + OpCount(smem=rounds * 8 * inside, rsqrt=rounds * inside,
                            madd=rounds * 3 * inside)
        if lo > 0:
            c = c + OpCount(smem=3 * px)     # the sums the slab before left
        if recompute:
            # The camera tile once, the projector tile once a chunk, mux;
            # the cross term's rows pass (a tile column of a plane an item)
            # and column sums (ROUND_COLS pixels of a row an item).
            rows = t["halo_rows"]
            stagings = _cdiv(planes, chunk)
            c = c + OpCount(smem=blocks * 2 * rows * (
                hc + stagings * (hc + chunk - 1)) + px)
            c = c + window_pass_cost(blocks * hc * planes, th, k, True)
            c = c + window_pass_cost(
                blocks * th * (tw // ROUND_COLS) * planes, ROUND_COLS, k,
                False)
        # Step b: per entry and plane slot ey2 and the volume loaded, the
        # store, an rsqrt, two FMA-pipe ops (and the head's); outside the
        # image a zero stored.
        c = c + OpCount(smem=slots * (3 * inside + outside),
                        rsqrt=slots * inside,
                        exp=slots * inside if head else 0,
                        madd=slots * inside * (2 + (7 if head else 0)))
        # The tile's own pixels: sy (K2 also the cost), B and GRMU (five
        # FMA-pipe ops), and with the recompute the window sum read and
        # the cost formed (three).
        c = c + OpCount(smem=slots * px * (1 if head else 2),
                        madd=slots * px * (8 if recompute else 5))
        c = c + window_pass_cost(
            blocks * (th // GRAD_ROWS) * hc * planes, GRAD_ROWS, k, False)
        c = c + window_pass_cost(
            blocks * th * (tw // GRAD_COLS) * planes, GRAD_COLS, k, False)
        c = c + OpCount(smem=2 * planes * px, madd=2 * planes * px)
    return c


def _cost_slabs_cost(H: int, W: int, D: int, k: int) -> OpCount:
    """K1's rounds kernel over each slab of the chunked route
    (:func:`_fused_rounds`), with K1's per pixel and plane rsqrt, five
    FMA-pipe ops and the slab's store; the slabs written once in all."""
    px = H * W
    c = OpCount()
    for lo, hi in cost_slabs(D):
        c = c + _fused_rounds(H, W, k, lo, hi, "K1 (a slab)")
    c = c + OpCount(rsqrt=(D + 1) * px, madd=(5 * (D + 1) + 1) * px)
    return _with_bytes(c, 0, (D + 1) * px * 4)


def camera_grad_rounds_cost(H: int, W: int, D: int, k: int, *, head: bool,
                            recompute: bool,
                            tile_rows: int = K_TILE_H) -> OpCount:
    """The rounds kernel of ``csrc/camera_grad.cuh``: K4 (``head``: g_d
    formed from six maps and the cost read), K6 (``recompute``: the
    cotangent read, the cost recomputed on the tile's own pixels) or K2
    (neither: the cotangent read, the cost read at the tile's own
    pixels); the statistics passes, the rounds kernel at
    :func:`grad_round`'s planes and chunk (:func:`_grad_rounds`), and the
    combine.  Past its block K4 reads its constants from their maps
    (:func:`k4_staged`), and K6 takes the chunked route
    (:func:`cost_slab_planes`): K1's rounds over each slab
    (:func:`_cost_slabs_cost`), then K2's rounds kernel on it.  The rounds
    kernel's tile is ``tile_rows`` rows (K4's may differ from the default
    16; the statistics and the combine stay at 16 x 64)."""
    name = "K4" if head else "K6" if recompute else "K2"
    slabs = recompute and cost_slab_planes("K6", k, D) > 0
    c = _stats_cost(H, W, k, W) + _stats_cost(H, W, k, W + D)
    c = c + _combine_cost(H, W, k, W)
    if slabs:
        c = c + _cost_slabs_cost(H, W, D, k) + _grad_rounds(
            H, W, k, cost_slabs(D), head=False, recompute=False, staged=True,
            name=name)
    else:
        c = c + _grad_rounds(
            H, W, k, ((0, D),), head=head, recompute=recompute,
            staged=not head or k4_staged(k, D, tile_rows=tile_rows),
            name=name, tile_rows=tile_rows)
    return _with_bytes(c, *_grad_bytes(H, W, D, head=head,
                                       cost_read=slabs or not recompute,
                                       c=c))


def _grad_bytes(H: int, W: int, D: int, *, head: bool, cost_read: bool,
                c: OpCount) -> Tuple[float, float]:
    """(read, written) bytes of a camera VJP: the images and statistics,
    the cotangent volume (or the head's seven maps) and the cost volume
    where read, A1 / B / GRMU written and read back by the combine, the
    gradient."""
    px, vol = H * W, (D + 1) * H * W * 4
    stats = (2 * px + 2 * H * (W + D)) * 4
    bytes_r = (c.bytes_r + stats
               + (7 * px * 4 if head else vol)              # maps or g
               + (vol if cost_read else 0)                 # cost
               + 3 * px * 4)                               # A1, B, GRMU
    bytes_w = c.bytes_w + 3 * px * 4 + px * 4              # A1, B, GRMU; grad
    return bytes_r, bytes_w


def volume_backward_cost(H: int, W: int, D: int, k: int,
                         with_cost: bool = True) -> OpCount:
    """K2 (``with_cost``) or K6 (``csrc/zncc_banded_bwd.cu``), the rounds
    kernel: reads the plane-major cotangent and K2 the cost at the tile's
    own pixels, where K6 recomputes it."""
    return camera_grad_rounds_cost(H, W, D, k, head=False,
                                   recompute=not with_cost)


def fused_backward_c_cost(H: int, W: int, D: int, k: int,
                          tile_rows: int = K_TILE_H) -> OpCount:
    """K4 (``csrc/fused_pipeline_bwd.cu``, the rounds kernel at a tile of
    ``tile_rows`` rows): the head's cotangent formed per plane from six
    staged maps and the cost read (one expf a halo entry and plane)."""
    return camera_grad_rounds_cost(H, W, D, k, head=True, recompute=False,
                                   tile_rows=tile_rows)


def fused_backward_cost(H: int, W: int, D: int, k: int) -> OpCount:
    """K5 (``fused_bwd_halo_kernel``, ``csrc/fused_pipeline_bwd.cu``): the
    statistics passes, the combine, and the halo kernel: the entries'
    eight constants staged, the camera tile staged once and the projector
    once a chunk (:func:`halo_round`); per plane the register-blocked
    cross-term rows pass over the halo'd rows and its column sums at every
    halo entry, then at each entry inside the image the cost, g_d and gr_d
    (two statistics loads, the sum read and gr written back, an rsqrt, an
    expf and twelve FMA-pipe ops; the tile's own pixels add two FMAs and
    two products for B and GRMU), gr's rows pass and column sums, and A1
    (the box sum and the projector read, a select and an FMA); an entry
    reads its constants once a round.  Where the halo kernel does not fit
    (:func:`halo_fits`), the chunked route: K1's rounds over each slab
    (:func:`_cost_slabs_cost`) and K4's rounds kernel on it."""
    if not halo_fits(k, D):
        # The chunked route: K1's rounds over each slab, K4's rounds kernel
        # on it.
        c = _stats_cost(H, W, k, W) + _stats_cost(H, W, k, W + D)
        c = c + _combine_cost(H, W, k, W) + _cost_slabs_cost(H, W, D, k)
        c = c + _grad_rounds(H, W, k, cost_slabs(D), head=True,
                             recompute=False,
                             staged=k4_staged(k, COST_CHUNK - 1), name="K5")
        return _with_bytes(c, *_grad_bytes(H, W, D, head=True,
                                           cost_read=True, c=c))
    p = k // 2
    nbh, nbw = _grid(H, W)
    blocks = nbh * nbw
    t = halo_tile(k, 1, 1)
    hr, hc, halo = t["halo_rows"], t["halo_cols"], t["halo"]
    img_rows, img_w = t["img_rows"], t["img_w"]
    px, planes = H * W, D + 1
    P, chunk = halo_round(k, D)
    rounds = sum(_cdiv(min(chunk, planes - d0), P)
                 for d0 in range(0, planes, chunk))
    stagings = _cdiv(planes, chunk)
    inside = _overlap(nbh, K_TILE_H, p, 0, H) * _overlap(nbw, K_TILE_W, p,
                                                         0, W)
    outside = blocks * halo - inside

    c = _stats_cost(H, W, k, W) + _stats_cost(H, W, k, W + D)
    c = c + _combine_cost(H, W, k, W)
    # Prologue: eight constants an entry (inside: two statistics and the
    # seven head maps loaded, a division, four products); the image tiles.
    c = c + OpCount(smem=17 * inside + HALO_CONSTS * outside
                    + blocks * 2 * img_rows * (
                        img_w + stagings * (img_w + chunk - 1)),
                    rsqrt=inside, madd=4 * inside)
    c = c + window_pass_cost(blocks * t["row_groups"] * img_w * planes,
                             HALO_ROWS, k, True)
    c = c + window_pass_cost(blocks * hr * _cdiv(hc, HALO_COLS) * planes,
                             HALO_COLS, k, False)
    c = c + OpCount(smem=planes * (4 * inside + outside)
                    + rounds * HALO_CONSTS * inside,
                    rsqrt=planes * inside, exp=planes * inside,
                    madd=planes * (12 * inside + 4 * px))
    c = c + window_pass_cost(
        blocks * (K_TILE_H // GRAD_ROWS) * hc * planes, GRAD_ROWS, k, False)
    c = c + window_pass_cost(
        blocks * K_TILE_H * (K_TILE_W // GRAD_COLS) * planes, GRAD_COLS, k,
        False)
    c = c + OpCount(smem=2 * planes * px, madd=2 * planes * px)
    return _with_bytes(c, *_grad_bytes(H, W, D, head=True, cost_read=False,
                                       c=c))


def projector_backward_cost(H: int, W: int, D: int, k: int) -> OpCount:
    """K7 (``csrc/zncc_banded_proj_bwd.cu``): the statistics passes
    (projector on the p-widened columns), the rounds kernel over the
    extended columns e in [0, W + p) at :func:`grad_round`'s planes (the
    projector's ey2 its one staged map, no recompute), and the combine.

    A round of P planes: every halo entry stores its P planes of g~r; where
    an entry's camera column ei - p + d lies in the image, g and ex2
    loaded, an rsqrt and two FMA-pipe ops; the tile's own pixels also load
    cam_s and the cost there and add z2 and z3 (five FMA-pipe ops); gr's
    rows pass and column sums; A1p (the box sum read, the camera read
    where x + d lies in the image, a select and an FMA) at pixels with
    x >= 0."""
    p = k // 2
    we = W + p
    nbh, nbw = _cdiv(H, K_TILE_H), _cdiv(we, K_TILE_W)
    blocks = nbh * nbw
    P, _ = grad_round(k, D, False, False)
    if P < 1:
        raise ValueError(f"K7 takes no k = {k} block on an H100")
    t = grad_round_tile(k, 1, P, head=False, recompute=False)
    hc, halo = t["halo_cols"], t["halo"]
    px, planes = H * W, D + 1
    slots = _cdiv(planes, P) * P             # planes step b computes
    rows_in = _overlap(nbh, K_TILE_H, p, 0, H)
    # Halo entries whose camera column ei - p + d lies in the image.
    shifted = sum(_overlap(nbw, K_TILE_W, p, max(0, p - d), W + p - d)
                  for d in range(planes))
    g_entries = rows_in * shifted
    prologue_in = rows_in * _overlap(nbw, K_TILE_W, p, 0, we)
    # Output pixels whose camera column x + d lies in the image (z2, z3 on
    # x in [-p, W); A1p's camera read on x in [0, W)).
    z_px = H * sum(W - d + min(p, d) for d in range(planes) if d < W)
    a1_px = H * sum(W - d for d in range(planes) if d < W)
    c = _stats_cost(H, W, k, W) + _stats_cost(H, W, k, we)
    c = c + _combine_cost(H, W, k, we)
    c = c + OpCount(
        smem=2 * prologue_in + (blocks * halo - prologue_in)
        + slots * blocks * halo + 2 * g_entries + 2 * z_px
        + planes * px + a1_px,
        rsqrt=g_entries,
        madd=2 * g_entries + 5 * z_px + 2 * planes * px)
    c = c + window_pass_cost(
        blocks * (K_TILE_H // GRAD_ROWS) * hc * planes, GRAD_ROWS, k, False)
    c = c + window_pass_cost(
        blocks * K_TILE_H * (K_TILE_W // GRAD_COLS) * planes, GRAD_COLS, k,
        False)
    vol = planes * px * 4
    stats = (2 * px + 2 * H * we) * 4
    bytes_r = c.bytes_r + 2 * vol + stats + (px + 2 * H * we) * 4
    bytes_w = c.bytes_w + (px + 2 * H * we) * 4 + px * 4
    return _with_bytes(c, bytes_r, bytes_w)


def allpairs_block_floats(k: int) -> int:
    """Shared memory of a K8 block in floats (``allpairs_smem_floats`` of
    zncc_allpairs.cu): the strip's ``AP_ROWS + k - 1`` camera and
    projector rows of the halo'd tile, or the block's window sums where
    they take more."""
    p = k // 2
    sums = AP_ROWS * AP_X_PER_THREAD * AP_Y_PER_THREAD * 32 * AP_WARPS
    return max((AP_ROWS + k - 1) * (AP_TILE_X + AP_TILE_Y + 4 * p), sums)


def allpairs_forward_cost(H: int, W: int, k: int) -> OpCount:
    """K8 (``csrc/zncc_allpairs.cu``): a block of ``32 AP_WARPS`` threads
    an ``AP_TILE_X x AP_TILE_Y`` (x, y) tile and a strip of ``AP_ROWS``
    output rows.  It stages the strip's ``AP_ROWS + k - 1`` camera and
    projector rows (a load and a store an entry); each thread computes
    the row product of its ``AP_X_PER_THREAD x AP_Y_PER_THREAD`` pairs
    for each of those rows: ``AP_X_PER_THREAD - 1`` camera loads to start,
    then per tap one camera load, ``AP_Y_PER_THREAD`` projector loads and
    a pair's FMA each.  Four FMAs issue beside a shared access, so the
    loads bind and the FMAs are not counted again (as
    :func:`window_pass_cost`).  Then k adds an output (the window sum over
    the rows), the sum stored to shared memory and read back, and per
    output a division, a sqrtf and a division (three multi-function ops)
    and three FMA-pipe ops; the exact [H, W, W] volume written."""
    if allpairs_block_floats(k) > SMEM_OPTIN_BYTES // 4:
        raise ValueError(f"K8 takes no k = {k} block on an H100")
    p = k // 2
    blocks = (_cdiv(H, AP_ROWS) * _cdiv(W, AP_TILE_X)
              * _cdiv(W, AP_TILE_Y))
    threads = blocks * 32 * AP_WARPS
    rows = AP_ROWS + k - 1
    pairs = AP_X_PER_THREAD * AP_Y_PER_THREAD
    access = AP_X_PER_THREAD - 1 + k * (1 + AP_Y_PER_THREAD)
    products = (OpCount(smem=threads * rows * access)
                if access * FMA_PER_SMEM >= k * pairs
                else OpCount(madd=threads * rows * k * pairs))
    out = H * W * W
    c = _stats_cost(H, W, k, W).scaled(2) + products
    c = c + OpCount(
        smem=blocks * 2 * rows * (AP_TILE_X + AP_TILE_Y + 4 * p)
        + threads * AP_ROWS * pairs * 2,
        madd=threads * AP_ROWS * pairs * k + 3 * out,
        rsqrt=3 * out)
    return _with_bytes(c, c.bytes_r + 4 * H * W * 4, c.bytes_w + out * 4)


def allpairs_backward_cost(H: int, W: int, k: int) -> OpCount:
    """Mandatory-traffic floor of the all-pairs camera backward (K8b,
    :func:`allpairs_grad_cost`; its plain version
    ``ops/zncc.py::camera_grad_allpairs``, as JAX leaves it to XLA): the
    cotangent and the cost residual read once each, the images read, the
    gradient written.  Priced at the data sheet's bandwidth (``bytes``
    only)."""
    vol = H * W * W
    c = OpCount()
    c.bytes = (2 * vol + 2 * H * W) * 4 + H * W * 4
    return c


def allpairs_grad_taps(W: int, k: int) -> Tuple[int, int]:
    """(first tap, taps) of K8b's E: the taps j of the k that meet a
    projector column of a ``W``-wide row, ``[max(0, p - W + 1), min(k, p +
    W))``; the others add nothing to A1 (k // 2 >= W leaves some out)."""
    p = k // 2
    lo = max(0, p - W + 1)
    return lo, min(k, p + W) - lo


def allpairs_grad_block_floats(W: int, k: int) -> int:
    """Shared memory of a K8b block in floats (``allpairs_grad_smem_floats``
    of zncc_allpairs_bwd.cu): the own rows' gr (then G2) and B entries of a
    chunk, the strip's projector rows over the chunk and a walk's taps
    (padded to an odd stride) and its sy rows, and a split's partial sums
    of GRMU, B and a walk's E."""
    groups = _cdiv(min(allpairs_grad_taps(W, k)[1], GB_TAP_CHUNK), GB_TAPS)
    psw = (GB_CHUNK_W + groups * GB_TAPS) | 1
    return (2 * GB_PAIRS * (GB_CHUNK_W + 1) + GB_ROWS * (psw + GB_CHUNK_W)
            + GB_SPLITS * GB_PAIRS * (2 + groups * GB_TAPS))


def allpairs_grad_cost(H: int, W: int, k: int) -> OpCount:
    """K8b (``csrc/zncc_allpairs_bwd.cu``): the main kernel, the diagonal
    sum and the combine, counted as a floor over the volume's n = H W^2
    entries.  Each walk over the columns reads every in-image row of each
    strip and its halo (``rows`` entries): ey2 from the caches, an rsqrt
    and two ops, and at a halo row the cotangent again from the caches;
    then the k-row window, k adds an output, and G2 stored.  At the own
    rows (the first walk): gr and B's entry (three ops) stored, then read
    back with sy for GRMU's FMA and B's add (three shared loads).  E's slid
    taps: two shared loads a column and group of ``GB_TAPS`` taps, its
    FMAs issuing beside them (the pipe that binds counted, as
    :func:`window_pass_cost` does).  The warp-uniform loads of ex2 and the
    staging of the projector and sy rows are not counted.  Then E out of
    shared memory, the diagonal sum (a cached load and an add a tap and
    pixel) and the combine (:func:`_combine_cost`).  Bytes: the cotangent
    and the cost once, the statistics and the projector, E written and
    read back, the three maps, the images, the gradient."""
    p = k // 2
    taps = allpairs_grad_taps(W, k)[1]
    walks = _cdiv(taps, GB_TAP_CHUNK)
    groups = _cdiv(taps, GB_TAPS)
    n, px = H * W * W, H * W
    rows = _overlap(_cdiv(H, GB_ROWS), GB_ROWS, p, 0, H) * W * W
    halo = rows - n
    c = OpCount(smem=walks * (rows + halo + n) + 5 * n + 2 * px * taps,
                rsqrt=walks * rows,
                madd=walks * (2 * rows + k * n) + 5 * n + px * taps)
    if 2 * FMA_PER_SMEM >= GB_TAPS:
        c = c + OpCount(smem=2 * n * groups)
    else:
        c = c + OpCount(madd=n * groups * GB_TAPS)
    c = c + _combine_cost(H, W, k, W)
    bytes_r = 2 * n * 4 + 4 * px * 4 + px * taps * 4 + 5 * px * 4
    bytes_w = px * taps * 4 + 3 * px * 4 + px * 4
    return _with_bytes(c, bytes_r, bytes_w)


def transpose_volume_cost(H: int, W: int, D: int) -> OpCount:
    """K9b (``transpose_kernel``, ``csrc/layout.cu``): every element read
    once, staged through a 32 x 32 shared tile (a store and a load),
    written once, the bytes at ``hbm_r3d`` and ``hbm_w3d`` as every
    volume's.  (Before K10b and K10c measured the card's bulk rates, the
    probes' thread-a-pixel write ran slower than K9b's stores, and K9b
    was priced at the data sheet's bandwidth.)  The plain
    ``permute().contiguous()`` moves the same bytes; its measured rate is
    ``t3d``."""
    n = (D + 1) * H * W
    return _with_bytes(OpCount(smem=2 * n), n * 4, n * 4)


def parity_chunks(R: int) -> Tuple[int, int, int]:
    """K9a's planes (``parity_chunks`` of csrc/layout.cu): (chunks, planes
    a chunk, a pixel's staged row stride): near-equal chunks of at most
    PARITY_CHUNK planes, the stride odd."""
    chunks = _cdiv(R, PARITY_CHUNK)
    planes = _cdiv(R, chunks)
    return chunks, planes, planes | 1


def parity_block_floats(D: int) -> int:
    """Shared memory of a K9a block in floats: PARITY_PIXELS staged rows
    of the chunk's stride."""
    return PARITY_PIXELS * parity_chunks(D + 1)[2]


def to_parity_cost(H: int, W: int, D: int) -> OpCount:
    """K9a (``to_parity_kernel``, ``csrc/layout.cu``): every element read
    once (a warp's 32 pixels of one plane, coalesced), stored to shared
    memory and loaded back (a store and a load), written once (with one
    chunk of planes a block's output is one contiguous span), the bytes at
    ``hbm_r3d`` and ``hbm_w3d``, as K9b's.  The plain
    ``permute().contiguous()`` moves the same bytes."""
    n = (D + 1) * H * W
    return _with_bytes(OpCount(smem=2 * n), n * 4, n * 4)


# ---------------------------------------------------------------------------
# The large-k route (csrc/large_k.cu, ops/cuda_large_k.py)
# ---------------------------------------------------------------------------

# The product kernels the route stands in for.
LARGE_K_KERNELS = ("K1", "K3", "K3w", "K3m", "K2", "K6", "K4", "K5", "K7",
                   "K8")


def stats_block_floats(k: int) -> int:
    """Shared memory of ``box_stats_kernel`` (common.cuh) in floats: the
    halo'd 16 x 64 tile and its two rows passes."""
    p = k // 2
    return (K_TILE_H + 2 * p) * (K_TILE_W + 2 * p) + 2 * K_TILE_H * (
        K_TILE_W + 2 * p)


def combine_block_floats(k: int) -> int:
    """Shared memory of the VJPs' combine kernels in floats
    (``camera_grad_combine_kernel``, ``proj_grad_combine_kernel``) with one
    map staged at a time: a halo'd tile and its rows pass."""
    p = k // 2
    return (2 * K_TILE_H + 2 * p) * (K_TILE_W + 2 * p)


def _slabs_fit(k: int, D: int, head: bool, budget: int) -> bool:
    """Whether every slab of the chunked route (K5, K6) fits: K1's rounds
    kernel on its planes and the rounds kernel reading them."""
    staged = not head or k4_staged(k, COST_CHUNK - 1, budget)
    return all(fused_round(k, hi - lo, budget)[0] >= 1
               and grad_round(k, hi - lo, head, False, staged, budget)[0] >= 1
               for lo, hi in cost_slabs(D))


def _rounds_fit(kernel: str, k: int, D: int, budget: int,
                tile_rows: int = K_TILE_H, planes: int = 0) -> bool:
    """Whether ``kernel``'s own blocks take (k, D) on an H100: the
    statistics tile and, for K8, its strip (``allpairs_block_floats``);
    for K1 and the K3 family a plane of ``fused_round`` (``planes`` where
    > 0); for K2 and K7 a plane of ``grad_round`` (and a combine a map at
    a time); for K4 its rounds with the constants staged or read from
    their maps; for K5 its halo kernel or every slab of the chunked route;
    for K6 its recomputing rounds or every slab.  The rounds kernels of K1,
    the K3 family and K4 at a tile of ``tile_rows`` rows; the others, the
    statistics and the combine at the default.  The launchers' geometry,
    mirrored, within ``budget`` floats."""
    if kernel not in LARGE_K_KERNELS:
        raise ValueError(f"no large-k route for {kernel}")
    if stats_block_floats(k) > budget:
        return False
    if kernel == "K8":
        return allpairs_block_floats(k) <= budget
    if kernel in ("K1", "K3", "K3w", "K3m"):
        return fused_round(k, D, budget, tile_rows, planes)[0] >= 1
    if combine_block_floats(k) > budget:
        return False
    if kernel in ("K2", "K7"):
        return grad_round(k, D, False, False, budget=budget)[0] >= 1
    if kernel == "K4":
        return grad_round(k, D, True, False,
                          k4_staged(k, D, budget, tile_rows), budget,
                          tile_rows)[0] >= 1
    if kernel == "K5":
        return halo_fits(k, D, budget) or _slabs_fit(k, D, True, budget)
    return (grad_round(k, D, False, True, budget=budget)[0] >= 1
            or _slabs_fit(k, D, False, budget))


def large_k_route(kernel: str, k: int, D: int = 0,
                  budget: Optional[int] = None, tile_rows: int = K_TILE_H,
                  planes: int = 0) -> bool:
    """Whether ``kernel`` takes the large-k route at (k, D): where its own
    blocks do not fit within ``budget`` floats (:func:`_rounds_fit`; an
    H100's by default), for K1, the K3 family and K4 at a tile of
    ``tile_rows`` rows (and for K1 and the K3 family ``planes`` a round
    where > 0).  The wrappers launch the route by it at their
    card's budget; on an H100 that is every odd k >= 129 for K1-K3 and
    K5-K7, k >= 187 for K4 and k >= 145 for K8.  ``chip_smoke.py`` pins it against the
    launchers on the card: each takes the last k below the route and
    refuses the first k on it."""
    return not _rounds_fit(kernel, k, D, _budget(budget), tile_rows,
                           planes)


def large_k_scratch(kernel: str, H: int, W: int, D: int, k: int
                    ) -> Dict[str, int]:
    """The large-k route's slab scratch of one frame (``_Slabs`` of
    ops/cuda_large_k.py, which sizes its buffers by it): ``planes`` a slab
    (``min(COST_CHUNK, D + 1)``), ``width`` of a plane (K7's fields live
    on the columns widened by p), ``buffers`` (products or gr, their row
    sums, and a slab of costs where the route recomputes them: K3, K3m,
    K5, K6), and their ``floats``.  Beside it the route holds only
    [H, W]-sized maps and what the call returns, so K3, K3m, K5 and K6
    never hold a whole volume.  K8's route needs none: its row sums are
    one [H, W, W] buffer beside the output."""
    if kernel not in LARGE_K_KERNELS:
        raise ValueError(f"no large-k route for {kernel}")
    if kernel == "K8":
        return {"planes": 0, "width": W, "buffers": 0, "floats": 0}
    planes = min(COST_CHUNK, D + 1)
    width = W + k // 2 if kernel == "K7" else W
    buffers = 3 if kernel in ("K3", "K3m", "K5", "K6") else 2
    return {"planes": planes, "width": width, "buffers": buffers,
            "floats": buffers * planes * H * width}


def _lk(n: float, loads: float, madd: float = 0, rsqrt: float = 0,
        exp: float = 0, nbytes: float = 0) -> OpCount:
    """One launch of a route kernel over ``n`` outputs: ``loads`` global
    loads and stores an output (L1/L2 served: ``smem``), FMA-pipe ops and
    multi-function ops an output, and ``nbytes`` of device memory, each
    input read once and each output written once, a dense stream priced
    at the data sheet's bandwidth (``bytes`` only)."""
    c = OpCount(smem=n * loads, madd=n * madd, rsqrt=n * rsqrt, exp=n * exp)
    c.bytes = float(nbytes)
    return c


def lk_box_items(N: int, H: int, W: int, axis: int) -> int:
    """Work items of ``box_axis`` (csrc/large_k.cu) over an ``[N, H, W]``
    stack: a thread's ``LK_BOX_OUT`` adjacent outputs of its line.  Along
    H (``axis`` 0) a block is 32 columns x a strip of ``LK_BOX_TILE`` rows,
    along W 32 rows of the stack x ``LK_BOX_TILE`` columns; a lane past the
    image sums zeros (counted), a group wholly past its end skips."""
    if axis == 0:
        return N * 32 * _cdiv(W, 32) * _cdiv(H, LK_BOX_OUT)
    return 32 * _cdiv(N * H, 32) * _cdiv(W, LK_BOX_OUT)


def lk_box_chunks(k: int) -> int:
    """Chunks a ``box_axis`` block stages its lines' span in: the tile and
    its k - 1 halo entries, ``LK_BOX_SPAN`` entries of a line at a time
    (one for every k <= 256)."""
    return _cdiv(LK_BOX_TILE + k - 1, LK_BOX_SPAN)


def _lk_box_axis(N: int, H: int, W: int, k: int, axis: int) -> OpCount:
    """One ``box_axis`` launch: its items on the register-blocked pass
    (``window_pass_cost``: ``LK_BOX_OUT + k - 1`` staged loads and
    ``LK_BOX_OUT`` stores an item, k adds an output, the first onto -0),
    the stack read and the sums written once."""
    c = window_pass_cost(lk_box_items(N, H, W, axis), LK_BOX_OUT, k, False)
    c.bytes = 8.0 * N * H * W
    return c


def _lk_box2d(N: int, H: int, W: int, k: int) -> OpCount:
    """box2d of an ``[N, H, W]`` stack: ``box_axis`` along H, then W."""
    return _lk_box_axis(N, H, W, k, 0) + _lk_box_axis(N, H, W, k, 1)


def _lk_row_products(H: int, W: int, k: int) -> OpCount:
    """``row_products`` of one frame: ``LK_RP_THREADS`` threads a block of
    ``LK_RP_TILE_X`` x ``LK_RP_TILE_Y`` (x, y) a row, each thread
    ``LK_RP_X_PER`` x ``LK_RP_Y_PER`` sums of k rounded products and adds
    (2 k FMA-pipe ops an output, tile padding included) from ``1 +
    LK_RP_Y_PER`` shared loads a tap, whichever pipe binds; the two rows
    read and the ``[H, W, W]`` products written once."""
    threads = H * _cdiv(W, LK_RP_TILE_X) * _cdiv(W, LK_RP_TILE_Y) * (
        LK_RP_THREADS)
    loads, ops = 1 + LK_RP_Y_PER, 2 * LK_RP_X_PER * LK_RP_Y_PER
    if loads * FMA_PER_SMEM >= ops:
        c = OpCount(smem=threads * k * loads)
    else:
        c = OpCount(madd=threads * k * ops)
    c.bytes = 8.0 * H * W + 4.0 * H * W * W
    return c


def _lk_moments(H: int, W: int, wx: int, k: int) -> OpCount:
    """S and E2 of an ``[H, W]`` image widened to ``wx`` columns:
    ``pad_square``, box2d of the pair, ``moments_finish``."""
    n = H * wx
    return (_lk(n, 3, madd=1, nbytes=4 * H * W + 8 * n)
            + _lk_box2d(2, H, wx, k)
            + _lk(n, 3, madd=3, rsqrt=1, nbytes=12 * n))


def _lk_slab_boxes(H: int, W: int, D: int, k: int) -> OpCount:
    """box2d of every slab of ``cost_slabs(D)`` (planes of ``W`` columns)."""
    c = OpCount()
    for lo, hi in cost_slabs(D):
        c = c + _lk_box2d(hi - lo + 1, H, W, k)
    return c


def _lk_cost_planes(H: int, W: int, D: int, k: int) -> OpCount:
    """K1's cost planes a slab at a time: ``band_products``, box2d,
    ``band_cost`` (five loads and a store, six FMA-pipe ops, a square root
    and two divisions an entry)."""
    n = (D + 1) * H * W
    return (_lk(n, 3, madd=1, nbytes=4 * n + 8 * H * W)
            + _lk_slab_boxes(H, W, D, k)
            + _lk(n, 6, madd=6, rsqrt=3, nbytes=8 * n))


def _lk_stats(H: int, W: int, D: int, k: int) -> OpCount:
    return _lk_moments(H, W, W, k) + _lk_moments(H, W, W + D, k)


def _lk_head(H: int, W: int, D: int) -> OpCount:
    """``online_head`` over every plane: a load, an expf and about five
    FMA-pipe ops a plane; the state (four maps) read and written a slab."""
    n, px = (D + 1) * H * W, H * W
    slabs = len(cost_slabs(D))
    return (_lk(n, 1, madd=5, exp=1, nbytes=4 * n)
            + _lk(px * slabs, 8, nbytes=32 * px * slabs))


def _lk_grad(H: int, W: int, D: int, k: int, head: bool,
             we: int = 0) -> OpCount:
    """The camera VJP's fields a slab at a time (``grad_fields``: four
    loads and a store, an rsqrt as a square root and a division, eight
    FMA-pipe ops a plane; the head's cotangent an expf and seven more),
    box2d of gr, ``grad_a1`` (two loads and two FMA-pipe ops a plane);
    then the stack, box2d of three maps and the combine.  ``we``: K7's
    extended width W + p (its fields on it), else W."""
    we = we or W
    n, px = (D + 1) * H * we, H * we
    c = _lk(n, 5, madd=8 + (7 if head else 0), rsqrt=2,
            exp=1 if head else 0, nbytes=4 * n * (2 if not head else 1))
    c = c + _lk_slab_boxes(H, we, D, k) + _lk(n, 2, madd=2, nbytes=4 * n)
    return (c + _lk(px, 6, madd=2, rsqrt=1, nbytes=24 * px)
            + _lk_box2d(3, H, we, k) + _lk(H * W, 5, madd=4,
                                           nbytes=20 * H * W))


def large_k_cost(kernel: str, H: int, W: int, D: int, k: int) -> OpCount:
    """The counted work of ``kernel``'s large-k route (csrc/large_k.cu,
    one frame): the statistics (:func:`_lk_moments`), K1's cost planes
    (:func:`_lk_cost_planes`), K3's head, the VJPs' fields and combine
    (:func:`_lk_grad`), or K8's row products (:func:`_lk_row_products`),
    row sums and normalisation (``W`` the width, ``D`` unused).  The
    window sums bind: k adds an output of each ``box_axis`` pass and 2 k
    FMA-pipe ops an output of the row products, priced at ``madd``."""
    if kernel == "K8":
        n = H * W * W
        return (_lk_moments(H, W, W, k).scaled(2)
                + _lk_row_products(H, W, k)
                + _lk_box_axis(1, H, W * W, k, 0)
                + _lk(n, 6, madd=6, rsqrt=3, nbytes=8 * n))
    if kernel == "K7":
        p = k // 2
        return (_lk_moments(H, W, W, k)
                + _lk_moments(H, W, W + p, k)
                + _lk_grad(H, W, D, k, False, W + p))
    c = _lk_stats(H, W, D, k)
    if kernel in ("K1", "K3", "K3w", "K3m", "K6", "K5"):
        c = c + _lk_cost_planes(H, W, D, k)
    if kernel.startswith("K3"):
        c = c + _lk_head(H, W, D)
    if kernel in ("K2", "K6", "K4", "K5"):
        c = c + _lk_grad(H, W, D, k, kernel in ("K4", "K5"))
    return c


def rate_probe_cost(mode: str, blocks: int, iters: int) -> OpCount:
    """K10a's own work: its elements in its own class, its output map."""
    c = OpCount(**{mode: rate_probe_elems(mode, blocks, iters)})
    return _with_bytes(c, 0, blocks * rate_probe_cols(mode) * 4)


def hbm_read_probe_cost(P: int, H: int, W: int) -> OpCount:
    """K10b's own work: the volume read, the [H, W] sums written."""
    return _with_bytes(OpCount(), P * H * W * 4, H * W * 4)


def hbm_write_probe_cost(P: int, H: int, W: int) -> OpCount:
    """K10c's own work: the volume written."""
    return _with_bytes(OpCount(), 0, P * H * W * 4)


def kernel_bound(cost: OpCount, rates: Optional[Dict[str, float]] = None,
                 hbm_bw: Optional[float] = None) -> Dict:
    """Bound (seconds, frames/s) of a counted kernel on this card."""
    from custereomatching_tpu_torch.utils.profiling import device_specs

    if rates is None:
        rates = measure_vpu_rates()
    if hbm_bw is None:
        hbm_bw = device_specs()["hbm_bw"]
    out = cost.time(rates, hbm_bw)
    out["bound_fps"] = 1.0 / out["bound_s"]
    return out


__all__ = ["LARGE_K_KERNELS", "OpCount", "TILE_ROWS",
           "allpairs_backward_cost", "allpairs_block_floats",
           "allpairs_forward_cost", "allpairs_grad_block_floats",
           "allpairs_grad_cost", "allpairs_grad_taps",
           "box_pass_loads", "camera_grad_rounds_cost",
           "combine_block_floats",
           "cost_slab_planes",
           "cost_slabs",
           "fused_backward_c_cost", "fused_backward_cost",
           "fused_block_floats", "fused_forward_cost", "fused_round",
           "grad_round",
           "grad_round_tile", "halo_fits", "halo_round",
           "halo_tile", "hbm_read_probe", "hbm_read_probe_cost",
           "hbm_read_reference", "hbm_write_probe", "hbm_write_probe_cost",
           "hbm_write_reference", "k4_staged", "kernel_bound",
           "large_k_cost", "large_k_route", "large_k_scratch",
           "lk_box_chunks", "lk_box_items", "measure_vpu_rates",
           "parity_block_floats", "parity_chunks",
           "projector_backward_cost", "rate_probe", "rate_probe_cost",
           "rate_probe_reference", "round_planes", "stage_op_cost",
           "stats_block_floats", "tile_cols",
           "to_parity_cost", "transpose_volume_cost",
           "volume_backward_cost",
           "volume_forward_cost", "window_pass_cost"]
