"""Wall-clock timer and a CUDA-event benchmark harness (PyTorch port).

The counterpart of ``custereomatching_tpu/utils/timer.py``.  ``Timer``
keeps the reference-compatible host wall-clock surface; device work is
measured by :func:`benchmark`, which times the card with CUDA events and
fails when there is no card.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch


# Cycles of the sleep kernel ahead of each sample of :func:`benchmark`:
# ~10 ms at the H100's 1.98 GHz.
_SLEEP_CYCLES = 20_000_000


class TimerError(Exception):
    """Raised when a Timer is queried while not running."""


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def fence(x: Any) -> Any:
    """Wait for the device work behind ``x``: synchronize the card, then
    read one element back to the host.  Returns ``x``."""
    tensors = _tensors(x)
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    for t in tensors:
        if t.numel():
            float(t.reshape(-1)[0])
            break
    return x


class Timer:
    """Context-manager wall-clock timer (API-compatible with the JAX
    package's ``Timer`` and the reference's ``custma.Timer``).

    Internally a list of monotonic lap stamps: index 0 is the origin,
    every query appends a stamp.  An empty lap list means "not running".
    This measures *host* time; for device work use :func:`benchmark`.
    """

    def __init__(self, print_tmpl: Optional[str] = None, start: bool = True):
        if print_tmpl is None:
            print_tmpl = "{:.3f}"
        elif "{" not in print_tmpl:
            print_tmpl = f"{print_tmpl} {{:.3f}}"
        self.print_tmpl = print_tmpl
        self._laps: List[float] = []
        if start:
            self.start()

    @property
    def is_running(self) -> bool:
        return bool(self._laps)

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        print(self.print_tmpl.format(self.since_last_check()))
        self._laps.clear()

    def start(self) -> None:
        """Start the timer, or reset the last-check stamp if running."""
        self._laps.append(time.perf_counter())
        self._trim()

    def _stamp(self) -> None:
        if not self._laps:
            raise TimerError("timer is not running")
        self._laps.append(time.perf_counter())
        self._trim()

    def _trim(self) -> None:
        # Queries only read the origin, previous and last stamps.
        if len(self._laps) > 3:
            del self._laps[1:-2]

    def since_start(self) -> float:
        self._stamp()
        return self._laps[-1] - self._laps[0]

    def since_last_check(self) -> float:
        self._stamp()
        return self._laps[-1] - self._laps[-2]


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    iters: int = 10,
    chain: int = 5,
    **kwargs: Any,
) -> Dict[str, float]:
    """Device time of ``fn(*args, **kwargs)`` on the card, per call.

    Runs ``warmup`` fenced calls (builds kernels, grows the allocator's
    pools), then ``iters`` samples; each sample is a CUDA-event interval
    around ``chain`` back-to-back calls on the current stream, divided by
    ``chain``.  Each sample's calls queue behind a sleep kernel of about 10
    ms, so that a call the host issues more slowly than the card runs it (a
    wrapper takes ~40 us to issue a kernel of 20 us) is timed by the card
    and not by the host.  Returns ``median_s``, ``mean_s``, ``min_s``,
    ``max_s``, ``std_s`` and ``iters``.  Raises ``RuntimeError`` without a
    card: a CPU time is never reported as a device time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark() times the CUDA device, and none is "
                           "available")
    for _ in range(warmup):
        fence(fn(*args, **kwargs))

    samples = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        fence(out)
        samples.append(start.elapsed_time(end) / 1e3 / chain)

    return {
        "median_s": statistics.median(samples),
        "mean_s": statistics.fmean(samples),
        "min_s": min(samples),
        "max_s": max(samples),
        "std_s": statistics.pstdev(samples),
        "iters": float(iters),
    }
