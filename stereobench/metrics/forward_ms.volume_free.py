"""Device time a step of the kernels and copies launched inside the port's
span ``custereo.model.volume_free``: the forward of a trainable call that
keeps no cost volume (K3m and its statistics pass; K5 runs later, in the
backward)."""

SPAN = "custereo.model.volume_free"


def read(t):
    s = t.span_seconds(lambda name: name == SPAN)
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
