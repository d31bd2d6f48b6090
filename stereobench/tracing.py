"""The traced stretch of a ``--trace 1`` run, and its reduction.

A run with ``--trace 1`` profiles a fixed number of steady calls inside
its window (``torch.profiler``, host and device), inside one span of its
own, ``stereobench.stretch``, whose length is the traced window.  The
profile is written to a temporary file under ``TMPDIR`` only to be read
back, and deleted there; nothing of it is kept.  The reduction gives the
per-layer readers (``metrics/``) a :class:`Summary`: device time by
kind, spans, launches, the least work of the stretch and the card's
peaks, and the ``breakdown`` of the result line.

Device time is attributed to a span through the CUDA runtime call that
launched it: a kernel or copy belongs to a span when its launch, on the
same host thread, lies inside the span.  Spans are the benchmark's own
(``stereobench.*``, around the calls into each layer) and the autograd
engine's (``autograd::engine::evaluate_function``, the backward).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from stereobench import leastwork

STRETCH = "stereobench.stretch"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "user_annotation", "python_function")
BACKWARD = "autograd::engine::evaluate_function"
OPTIMIZER = "stereobench.optimizer_step"
TOP = 10


def span(name: str, on: bool):
    """A profiler span around a call into a layer, where tracing is on."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


class Stretch:
    """Profiles units ``[first, first + count)`` of a window: call
    :meth:`at` with the number of units done before each unit, and
    :meth:`close` once the window is over."""

    def __init__(self, enabled: bool, first: int, count: int,
                 device: torch.device):
        self.enabled = enabled
        self.first, self.count = first, count
        self.device = device
        self.prof = None
        self.span = None
        self.units = 0
        self.window_s = 0.0
        self._t0 = 0.0
        self.events: Optional[List[dict]] = None

    @property
    def last(self) -> int:
        """Units a window needs before this stretch is complete."""
        return self.first + self.count if self.enabled else 0

    def due(self, done: int) -> bool:
        """Whether a started stretch has its units."""
        return self.span is not None and done >= self._done0 + self.count

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def at(self, done: int) -> None:
        if not self.enabled:
            return
        if done == self.first and self.prof is None:
            self.start(done)
        elif done == self.first + self.count and self.span is not None:
            self.stop(done)

    def start(self, done: int) -> None:
        """Start profiling; ``done`` is the units done so far."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()
        self._done0 = done
        self._t0 = time.perf_counter()

    def stop(self, done: int) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.span.__exit__(None, None, None)
        self.span = None
        self.prof.stop()
        self.units = done - self._done0

    def close(self) -> None:
        """Read the profile back (after the window), if one was taken."""
        if self.prof is None or self.events is not None:
            return
        if self.span is not None:
            raise RuntimeError("the traced stretch never closed")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "stretch.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f)["traceEvents"]
                               if e.get("ph") == "X"]
        self.prof = None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _length(intervals: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class Summary:
    """What the readers of ``metrics/`` read (times in seconds)."""

    def __init__(self, events: List[dict], units: int, frames: int,
                 work: leastwork.Work, peaks: Optional[Dict[str, float]]):
        self.units, self.frames = units, frames
        self.work, self.peaks = work, peaks
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") in HOST]
        if not stretch:
            raise RuntimeError("the trace holds no stretch span")
        s = stretch[0]
        self.lo, self.hi = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.window_s = (self.hi - self.lo) * 1e-6
        self.device = [e for e in events if e.get("cat") in DEVICE
                       and float(e["ts"]) < self.hi
                       and float(e["ts"]) + float(e["dur"]) > self.lo]
        self.runtime = {e.get("args", {}).get("correlation"): e
                        for e in events if e.get("cat") in RUNTIME}
        host = defaultdict(list)
        for e in events:
            if e.get("cat") in HOST and e.get("name") != STRETCH:
                host[(e["pid"], e["tid"])].append(e)
        for evs in host.values():
            evs.sort(key=lambda e: float(e["ts"]))
        self._host = host
        self._starts = {key: [float(e["ts"]) for e in evs]
                        for key, evs in host.items()}
        self._longest = {key: max(float(e["dur"]) for e in evs)
                         for key, evs in host.items()}

        def intervals(cat=None):
            return _merge(_clip([(float(e["ts"]), float(e["ts"])
                                  + float(e["dur"])) for e in self.device
                                 if cat is None or e["cat"] == cat],
                                self.lo, self.hi))

        self.busy_s = _length(intervals()) * 1e-6
        self.kernel_s = _length(intervals("kernel")) * 1e-6
        self.copy_s = sum(float(e["dur"]) for e in self.device
                          if e["cat"] == "gpu_memcpy") * 1e-6
        self.launches = sum(1 for e in self.device if e["cat"] == "kernel")
        self._gaps = self._idle_gaps(intervals())

    # -- attribution -------------------------------------------------------
    def _launch(self, dev: dict) -> Optional[dict]:
        return self.runtime.get(dev.get("args", {}).get("correlation"))

    def _enclosing(self, rt: dict) -> List[dict]:
        """Host events on the launch's thread that enclose it, outermost
        first."""
        key = (rt["pid"], rt["tid"])
        if key not in self._host:
            return []
        evs, starts = self._host[key], self._starts[key]
        t = float(rt["ts"])
        i = bisect.bisect_right(starts, t)
        j = bisect.bisect_left(starts, t - self._longest[key])
        return [e for e in evs[j:i] if float(e["ts"]) + float(e["dur"]) >= t]

    def span_seconds(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device time of the kernels and copies launched inside the spans
        whose name ``match`` accepts; None where no such span was
        traced."""
        found = False
        total = 0.0
        for dev in self.device:
            rt = self._launch(dev)
            if rt is None:
                continue
            if any(match(e["name"]) for e in self._enclosing(rt)):
                found = True
                total += float(dev["dur"])
        if not found:
            spans = any(match(e["name"]) for evs in self._host.values()
                        for e in evs)
            return 0.0 if spans else None
        return total * 1e-6

    # -- breakdown ---------------------------------------------------------
    def _label(self, dev: Optional[dict]) -> str:
        if dev is None:
            return "end of the stretch"
        rt = self._launch(dev)
        if rt is None:
            return "host not traced"
        chain = self._enclosing(rt)
        if not chain:
            return rt["name"]
        outer, inner = chain[0]["name"], chain[-1]["name"]
        return outer if outer == inner else f"{outer} > {inner}"

    def _idle_gaps(self, busy) -> Dict[str, float]:
        starts = sorted(self.device, key=lambda e: float(e["ts"]))
        keys = [float(e["ts"]) for e in starts]
        gaps: Dict[str, float] = defaultdict(float)
        edge = self.lo
        for lo, hi in busy + [(self.hi, self.hi)]:
            if lo > edge:
                j = bisect.bisect_left(keys, lo)
                nxt = starts[j] if j < len(starts) else None
                gaps[self._label(nxt)] += (lo - edge) * 1e-6
            edge = max(edge, hi)
        return dict(gaps)

    def breakdown(self) -> Dict[str, List[list]]:
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[e["name"]] += float(e["dur"]) * 1e-6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self._gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def is_backward(name: str) -> bool:
    return name.startswith(BACKWARD)


def is_optimizer(name: str) -> bool:
    return name == OPTIMIZER
