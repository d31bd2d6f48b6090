"""Utilities: host timer, the CUDA-event benchmark harness and the
disparity metrics."""

from custereomatching_tpu_torch.utils.metrics import (
    bad_pixel_rate,
    disparity_metrics,
    end_point_error,
)
from custereomatching_tpu_torch.utils.timer import (
    Timer,
    TimerError,
    benchmark,
    fence,
)

__all__ = ["Timer", "TimerError", "bad_pixel_rate", "benchmark",
           "disparity_metrics", "end_point_error", "fence"]
