"""Utilities: host timer and the CUDA-event benchmark harness."""

from custereomatching_tpu_torch.utils.timer import (
    Timer,
    TimerError,
    benchmark,
    fence,
)

__all__ = ["Timer", "TimerError", "benchmark", "fence"]
