"""Device time a step of the kernels launched inside the optimizer's step
(the benchmark's span ``stereobench.optimizer_step``, opened and closed
by the optimizer's step hooks)."""

from stereobench import tracing


def read(t):
    s = t.span_seconds(tracing.is_optimizer)
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
