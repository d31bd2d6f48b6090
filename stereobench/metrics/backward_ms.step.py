"""Device time a step of the kernels launched by the autograd engine's
backward (its ``evaluate_function`` spans): K4 at KITTI, the all-pairs
camera VJP behind K8's node."""

from stereobench import tracing


def read(t):
    s = t.span_seconds(tracing.is_backward)
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
