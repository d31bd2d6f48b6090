"""Tile autotuning of the rounds kernels on the card (K1, K3 and K4).

The counterpart of ``custereomatching_tpu/ops/tuning.py``, with its
public names.  On the TPU the search space was the Pallas blocks
``(block_rows, block_disparities)``; here it is the rounds kernel's tile
(``csrc/common.cuh`` ``Tile``): ``block_rows`` is the tile's rows (8, 16
or 32, of 1024 / rows columns: one 1024-thread block an SM at every
tile) and ``block_disparities`` the planes a round.  The trade-offs: a
shorter tile stages more halo rows a pixel, a narrower one more halo
columns; more planes a round spend fewer barriers but leave threads idle
in a round's last pass; a taller tile makes the rows pass's register
block longer (``window_taps<TH>``).  The values are the same at every
tile, bit for bit (each window sum adds its taps, each pixel its planes,
in the same order), so a tuned tile changes time, never an output.

* **Candidates are derived, not hardcoded**: :func:`candidate_blocks`
  enumerates the tiles and, for K1 and K3, a lattice of planes a round
  around each tile's own choice, and keeps those whose block fits the
  card's opt-in shared memory, by the bound model's mirror of the
  launchers' geometry (``utils.kernel_model.large_k_route``): a tile
  whose kernel would leave its own blocks is never measured.
* **Model-ranked**: where the card's K10 rates are cached
  (``kernel_model.measure_vpu_rates``), candidates are ranked by the
  model's bound at those rates (no probe runs to rank them) and the top
  few are measured, the default tile always among them.
* **Persistent cache**: winners are stored per (card name, kernel,
  shape) in a JSON cache (``CUSTEREO_TUNE_CACHE`` overrides the path), so
  a serving process warm-starts across restarts.

Opt-in by design: pass a result through ``dataclasses.replace(config,
pipeline_blocks=...)`` (K3, K3w, K3m), ``trainable_bwd_block_rows=...``
(K4), or the ``tile_rows, planes`` arguments of
``ops.cuda_zncc.cost_volume_banded_cuda`` (K1).  Every entry point
measures the card and raises ``RuntimeError`` without one: the plain
versions have no tile to tune.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from custereomatching_tpu_torch.config import entry_device
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils.profiling import PEAK_BYTES

Blocks = Tuple[int, int]

_CACHE: Dict[tuple, Blocks] = {}

_DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "custereomatching_tpu_torch",
    "autotune.json")

# Bump when a kernel's tile semantics change: winners measured against an
# older kernel generation must not pin tiles for the new one.
_SCHEMA = "torch-v1"

# The kernel each kind tunes.
_KERNELS = {"pipeline": "K3", "volume": "K1", "trainable_bwd": "K4"}


def _cache_path() -> str:
    return os.environ.get("CUSTEREO_TUNE_CACHE", _DEFAULT_CACHE_PATH)


def _load_disk_cache() -> Dict[str, object]:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk_cache(key: str, value: Blocks,
                      probe: Optional[dict] = None) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cache = _load_disk_cache()
        entry: dict = {"blocks": list(value)}
        if probe:
            entry.update(probe)
        cache[key] = entry
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _disk_blocks(entry) -> Blocks:
    """Blocks from a disk entry: a dict with ``blocks``, or a bare list
    (the JAX cache's first form)."""
    if isinstance(entry, dict):
        entry = entry["blocks"]
    return tuple(entry)


def _disk_key(key: tuple) -> str:
    """The disk cache's key: the schema, the card's name, then ``key``."""
    kind = (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "unknown")
    return f"{_SCHEMA}|{kind}|" + "|".join(str(x) for x in key)


# ---------------------------------------------------------------------------
# Candidates from the launchers' shared-memory arithmetic
# ---------------------------------------------------------------------------

def _tile_rows(height: int) -> List[int]:
    """The tiles worth trying on an image of ``height`` rows, the
    default's first: none taller than the image rounded up to 8 (or 16,
    the default's)."""
    top = max(-(-height // 8) * 8, km.K_TILE_H)
    return sorted((th for th in km.TILE_ROWS if th <= top),
                  key=lambda th: (th != km.K_TILE_H, th))


def _predicated_rows_pass(kind: str, tile_rows: int, kernel_size: int
                         ) -> bool:
    """Whether ``kind``'s rows pass takes its predicated loop at this
    tile: K1's and K3's make ``tile_rows`` outputs a column
    (``window_taps<TH>``, common.cuh), and below k = TH - 1 each of their
    TH + k - 1 entries is tested against all TH outputs, which the bound
    model does not count.  K4's rows pass makes 8 outputs at every tile."""
    return kind != "trainable_bwd" and kernel_size < tile_rows - 1


def candidate_blocks(kind: str, height: int, width: int,
                     num_disparities: int, kernel_size: int,
                     budget: Optional[int] = None) -> List[Blocks]:
    """Feasible ``(block_rows, block_disparities)`` for ``kind``
    (``"pipeline"``: K3, K3w and K3m; ``"volume"``: K1;
    ``"trainable_bwd"``: K4): the tile's rows and the planes a round.

    For K1 and K3 each tile offers its own planes a round (the most that
    give every thread one rows-pass column and fit,
    ``kernel_model.round_planes``), half that, two and three times it, and
    the most that fit beside the whole projector staged once, where they
    fit and give rounds (planes, chunk) not already listed.
    For ``"trainable_bwd"`` only ``block_rows`` is free: the planes a
    round are the ones K4's launcher picks at that tile
    (``kernel_model.grad_round``).  A candidate is kept where its kernel
    runs its own blocks at (k, D) within ``budget`` floats of shared
    memory (an H100's by default): ``kernel_model.large_k_route`` at that
    tile.  A tile other than the default is left out where its rows pass
    takes the predicated loop (:func:`_predicated_rows_pass`: 32 rows at
    k < 31, 8 rows at k < 7): the model would rank it by work it does not
    count (32-row tiles ran 4-8 times the default's time at k = 15 on an
    H100).  The default tile, 16 rows at its own planes, comes first
    wherever it runs; where no tile does (the large-k route) the list is
    empty.
    """
    if kind not in _KERNELS:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{sorted(_KERNELS)}")
    kernel = _KERNELS[kind]
    D, k = int(num_disparities), int(kernel_size)
    budget = km._budget(budget)
    out: List[Blocks] = []
    for th in _tile_rows(height):
        if km.large_k_route(kernel, k, D, budget, th) or (
                th != km.K_TILE_H and _predicated_rows_pass(kind, th, k)):
            continue
        if kind == "trainable_bwd":
            staged = km.k4_staged(k, D, budget, th)
            out.append((th, km.grad_round(k, D, True, False, staged, budget,
                                          th)[0]))
            continue
        one = km.round_planes(k, D, budget, th)
        # The most planes a round beside the whole projector staged once.
        fixed, per = km._round_floats(k, D + 1, th)
        once = max(1, (budget - fixed) // per)
        seen = set()
        for planes in dict.fromkeys((one, max(1, one // 2), 2 * one,
                                     3 * one, once)):
            rounds = km.fused_round(k, D, budget, th, planes)
            if rounds[0] < 1 or rounds in seen:
                continue
            seen.add(rounds)
            out.append((th, planes))
    return out


def _cost(kind: str, blocks: Blocks, height: int, width: int, D: int,
          k: int) -> km.OpCount:
    """The bound model's count of ``kind``'s kernel at ``blocks``."""
    th, planes = blocks
    if kind == "pipeline":
        return km.fused_forward_cost(height, width, D, k, tile_rows=th,
                                     planes=planes)
    if kind == "volume":
        return km.volume_forward_cost(height, width, D, k, th, planes)
    return km.fused_backward_c_cost(height, width, D, k, th)


def model_ms(kind: str, blocks: Blocks, height: int, width: int, D: int,
             k: int, rates: Dict[str, float]) -> float:
    """The bound model's time of ``kind``'s kernel at ``blocks`` and the
    given K10 rates, in milliseconds (the memory leg at the rates' HBM
    probes, or without them at an H100's data-sheet bandwidth)."""
    return 1e3 * km.kernel_bound(_cost(kind, blocks, height, width, D, k),
                                 rates, PEAK_BYTES)["bound_s"]


def _cached_rates() -> Optional[Dict[str, float]]:
    """The card's cached K10 rates, or None (no card, or none cached):
    ranking never runs a probe."""
    if not torch.cuda.is_available():
        return None
    return km.measure_vpu_rates(measure_if_missing=False)


def _rank_candidates(kind: str, cands: Sequence[Blocks], height: int,
                     width: int, D: int, k: int,
                     rates: Optional[Dict[str, float]] = None
                     ) -> List[Blocks]:
    """``cands`` in the order of their model time at the cached K10 rates
    (``rates`` when given), ties in the order given; unranked where no
    rates are cached."""
    rates = _cached_rates() if rates is None else rates
    if not rates:
        return list(cands)
    return sorted(cands, key=lambda c: model_ms(kind, c, height, width, D,
                                                k, rates))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

# Cycles the card sleeps ahead of a timed chain (about 2 ms on an H100),
# long enough for the host to enqueue the chain's calls behind it.
_HEAD_START_CYCLES = 4_000_000


def _slope_time(fn: Callable[[], object], n1: int = 4,
                n2: int = 12) -> float:
    """Per-call steady-state seconds of ``fn`` on the card: the slope
    between chains of ``n1`` and ``n2`` back-to-back calls, the median of
    three.  Each chain is timed by CUDA events on the current stream
    behind a device-side sleep (``torch.cuda._sleep``), so the host has
    enqueued the calls before the first runs: at a small shape, where a
    wrapper's host time passes its kernel's, the events read the card's
    time, not the host's; the slope removes what a chain pays once."""

    def chain(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HEAD_START_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    fn()                          # builds, grows the allocator's pools
    torch.cuda.synchronize()
    chain(n2)
    slopes = sorted((chain(n2) - chain(n1)) / (n2 - n1) for _ in range(3))
    return max(slopes[1], 1e-9)


# The most K10a's madd rate may fall below the card's cached rate before
# the measurement window counts as degraded (as scripts/device_probe.py's
# --max-slowdown: the FMA pipe is the class most of the rounds kernels'
# work is priced in), and the absolute limit without a cached rate
# (device_probe's --abs-madd-ps).
_PROBE_MAX_SLOWDOWN = 2.0
_PROBE_ABS_MADD_S = 0.1e-12


def _probe_health() -> Tuple[Optional[bool], Optional[float],
                             Optional[float]]:
    """``(ok, madd_s_per_elem, reference_s_per_elem)``: K10a's madd rate
    now against the card's cached rate (``ok`` None where the probe cannot
    run: no card)."""
    if not torch.cuda.is_available():
        return None, None, None
    cached = km.measure_vpu_rates(measure_if_missing=False)
    ref = cached.get("madd") if cached else None
    madd = km._run_rate("madd")
    if ref is None:
        return madd <= _PROBE_ABS_MADD_S, madd, None
    return madd <= ref * _PROBE_MAX_SLOWDOWN, madd, ref


def _first_line(e: BaseException) -> str:
    return (str(e).splitlines() or [""])[0][:160]


def _tune(key: tuple, candidates: Sequence[Blocks],
          build: Callable[[int, int], Callable[[], object]],
          measure_top: int, probe: bool = True) -> Blocks:
    """The fastest of ``candidates[:measure_top]``: ``build(rows,
    planes)`` gives the call to time (:func:`_slope_time`).  Cached in
    process under ``key`` and on disk under :func:`_disk_key`; a disk hit
    measures nothing.  Where K10a's probe reports a degraded window
    (:func:`_probe_health`), the winner is kept in process only, with a
    warning.  A candidate whose call raises (``ValueError`` or a CUDA
    error) is skipped; where all do, ``RuntimeError`` names the first
    failures."""
    if key in _CACHE:
        return _CACHE[key]
    dk = _disk_key(key)
    disk = _load_disk_cache()
    if dk in disk:
        best = _disk_blocks(disk[dk])
        _CACHE[key] = best
        return best
    persist, probe_meta = True, None
    if probe:
        ok, madd, ref = _probe_health()
        if ok is False:
            warnings.warn(
                "autotune: the card's K10a probe reports a degraded window "
                f"(madd {madd * 1e12:.4f} ps/elem vs reference "
                f"{(ref or 0) * 1e12:.4f}); the measured winner will NOT "
                "be persisted to the disk cache", RuntimeWarning,
                stacklevel=3)
            persist = False
        elif ok is True:
            probe_meta = {"probe_madd_ps": round(madd * 1e12, 4)}
            if ref is not None:
                probe_meta["ref_madd_ps"] = round(ref * 1e12, 4)
    best, best_t = None, float("inf")
    failures = []
    for rows, planes in candidates[:measure_top]:
        try:
            t = _slope_time(build(rows, planes))
        except (ValueError, RuntimeError) as e:
            failures.append(((rows, planes),
                             f"{type(e).__name__}: {_first_line(e)}"))
            continue
        if t < best_t:
            best, best_t = (rows, planes), t
    if best is None:
        detail = "; ".join(f"{c}: {m}" for c, m in failures[:3])
        raise RuntimeError(
            f"no autotune candidate ran ({len(failures)} tried). If this "
            f"list includes the default tile, suspect the card, not the "
            f"candidates. First failures: {detail}")
    _CACHE[key] = best
    if persist:
        _store_disk_cache(dk, best, probe_meta)
    return best


def _pair(height: int, width: int, device: torch.device):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.random((1, height, width),
                                             dtype=np.float32)).to(device)
                 for _ in range(2))


def _measured(ranked: List[Blocks], default: Blocks,
              measure_top: int) -> List[Blocks]:
    """The candidates the tuner times: the first ``measure_top`` of
    ``ranked``, the default tile in place of the last where the model put
    it lower, so a tuned tile is never one that lost to the default."""
    top = list(ranked[:measure_top])
    if top and default not in top:
        top[-1] = default
    return top


def _candidates(kind: str, candidates, height: int, width: int, D: int,
                k: int, device: torch.device,
                measure_top: int) -> List[Blocks]:
    """The candidates to time: ``candidates`` as given, or the derived
    ones (:func:`candidate_blocks`), model-ranked, the default among
    them (:func:`_measured`)."""
    if candidates:
        return [tuple(c) for c in candidates][:measure_top]
    from custereomatching_tpu_torch.ops.cuda_zncc import smem_floats

    cands = candidate_blocks(kind, height, width, D, k, smem_floats(device))
    if not cands:
        return []
    ranked = _rank_candidates(kind, cands, height, width, D, k)
    return _measured(ranked, cands[0], measure_top)


def autotune_pipeline_blocks(
    height: int,
    width: int,
    num_disparities: int,
    kernel_size: int = 15,
    candidates: Optional[Sequence[Blocks]] = None,
    measure_top: int = 6,
) -> Optional[Blocks]:
    """Best ``(block_rows, block_disparities)`` for K3 (and K3w, K3m:
    ``StereoConfig.pipeline_blocks``) at this shape: derived candidates,
    model-ranked, the top few measured on the card.  Cached in process and
    on disk.  None (the default tile, unmeasured) where no tile runs its
    own blocks (the large-k route).  Raises ``RuntimeError`` without a
    card."""
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        stereo_pipeline_cuda,
    )

    device = entry_device()
    D, k = int(num_disparities), int(kernel_size)
    cands = _candidates("pipeline", candidates, height, width, D, k, device,
                        measure_top)
    if not cands:
        return None
    key = ("pipeline", height, width, D, k, tuple(cands))
    cam, proj = _pair(height, width, device)

    def build(rows, planes):
        return lambda: stereo_pipeline_cuda(cam, proj, D, k, 1e-8, 50.0,
                                            0.6, rows, planes).soft_disparity

    return _tune(key, cands, build, len(cands))


def autotune_volume_blocks(
    height: int,
    width: int,
    num_disparities: int,
    kernel_size: int = 15,
    candidates: Optional[Sequence[Blocks]] = None,
    measure_top: int = 6,
) -> Optional[Blocks]:
    """Best ``(block_rows, block_disparities)`` for K1 at this shape (the
    ``tile_rows, planes`` of ``cuda_zncc.cost_volume_banded_cuda``).
    Cached in process and on disk; None where no tile runs its own
    blocks.  Raises ``RuntimeError`` without a card."""
    from custereomatching_tpu_torch.ops.cuda_zncc import (
        cost_volume_banded_cuda,
    )

    device = entry_device()
    D, k = int(num_disparities), int(kernel_size)
    cands = _candidates("volume", candidates, height, width, D, k, device,
                        measure_top)
    if not cands:
        return None
    key = ("volume", height, width, D, k, tuple(cands))
    cam, proj = _pair(height, width, device)

    def build(rows, planes):
        return lambda: cost_volume_banded_cuda(cam, proj, D, k, 1e-8, rows,
                                               planes)

    return _tune(key, cands, build, len(cands))


def autotune_trainable_bwd_blocks(
    height: int,
    width: int,
    num_disparities: int,
    kernel_size: int = 15,
    candidates: Optional[Sequence[Blocks]] = None,
    measure_top: int = 5,
) -> Optional[int]:
    """Best ``block_rows`` for K4, the trainable backward with the cost
    volume (``StereoConfig.trainable_bwd_block_rows``), at this shape: the
    planes a round are the launcher's at each tile.  Measures K4 alone on
    the residuals of one K3w forward, the soft disparity's cotangent ones
    and the confidence's zeros.  Cached in process and on disk; None where
    no tile runs its own blocks.  Raises ``RuntimeError`` without a
    card."""
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
        fused_pipeline_train_cuda,
    )

    device = entry_device()
    D, k = int(num_disparities), int(kernel_size)
    cands = _candidates("trainable_bwd", candidates, height, width, D, k,
                        device, measure_top)
    if not cands:
        return None
    key = ("trainable_bwd", height, width, D, k, tuple(cands))
    if key in _CACHE:
        return _CACHE[key][0]
    cam, proj = _pair(height, width, device)
    _, res = fused_pipeline_train_cuda(cam, proj, D, k, 1e-8, 50.0, 0.6)
    gsoft = torch.ones_like(cam)
    gconf = torch.zeros_like(cam)

    def build(rows, planes):
        return lambda: fused_pipeline_bwd_cuda(cam, proj, res, gsoft, gconf,
                                               D, k, 1e-8, 50.0, rows)

    best = _tune(key, cands, build, len(cands))
    return None if best is None else best[0]


# The JAX module's names for its shipped candidate sets; on the card they
# are the derived candidates at the KITTI production shape (375 x 1242,
# D = 192, k = 15) within an H100's shared memory.
PIPELINE_CANDIDATES: Tuple[Blocks, ...] = tuple(
    candidate_blocks("pipeline", 375, 1242, 192, 15))
VOLUME_CANDIDATES: Tuple[Blocks, ...] = tuple(
    candidate_blocks("volume", 375, 1242, 192, 15))

__all__ = ["PIPELINE_CANDIDATES", "VOLUME_CANDIDATES",
           "autotune_pipeline_blocks", "autotune_trainable_bwd_blocks",
           "autotune_volume_blocks", "candidate_blocks", "model_ms"]
