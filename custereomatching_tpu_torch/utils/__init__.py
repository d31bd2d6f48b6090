"""Utilities: host timer, the CUDA-event benchmark harness, the disparity
metrics, failure classification, retries and the health probe
(``failsafe``), the port's spans, the card's peaks and least-work bounds
(``profiling``) and the calibrated bound model with its rate probes
(``kernel_model``)."""

from custereomatching_tpu_torch.utils.failsafe import (
    device_healthcheck,
    is_transient_device_error,
    with_retries,
)
from custereomatching_tpu_torch.utils.kernel_model import (
    OpCount,
    allpairs_backward_cost,
    allpairs_forward_cost,
    fused_backward_c_cost,
    fused_backward_cost,
    fused_forward_cost,
    kernel_bound,
    measure_vpu_rates,
    projector_backward_cost,
    to_parity_cost,
    transpose_volume_cost,
    volume_backward_cost,
    volume_forward_cost,
)
from custereomatching_tpu_torch.utils.metrics import (
    bad_pixel_rate,
    disparity_metrics,
    end_point_error,
)
from custereomatching_tpu_torch.utils.profiling import (
    DEVICE_SPECS,
    device_specs,
    span,
    trace,
    zncc_roofline,
)
from custereomatching_tpu_torch.utils.timer import (
    Timer,
    TimerError,
    benchmark,
    fence,
)

__all__ = ["DEVICE_SPECS", "OpCount", "Timer", "TimerError",
           "allpairs_backward_cost", "allpairs_forward_cost",
           "bad_pixel_rate", "benchmark", "device_healthcheck",
           "device_specs",
           "disparity_metrics", "end_point_error", "fence",
           "fused_backward_c_cost", "fused_backward_cost",
           "fused_forward_cost", "is_transient_device_error",
           "kernel_bound", "measure_vpu_rates",
           "projector_backward_cost", "span", "to_parity_cost", "trace",
           "transpose_volume_cost",
           "volume_backward_cost", "volume_forward_cost", "with_retries",
           "zncc_roofline"]
