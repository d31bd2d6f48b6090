"""The backward's least-work time over the device time of what the
autograd engine's backward launched (its ``evaluate_function`` spans), a
step: every entry's cotangent and camera VJP (``leastwork_train.backward``)
against K5 and whatever else the backward runs, read the same whatever
implements it."""

from stereobench import tracing


def read(t):
    backward = getattr(t.work, "backward", None)
    if backward is None or t.peaks is None or t.units == 0:
        return None
    s = t.span_seconds(tracing.is_backward)
    if not s:
        return None
    return 100.0 * t.units * backward.seconds(t.peaks) / s
