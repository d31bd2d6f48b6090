"""Device time a call of the kernels and copies launched inside the
pyramid's glue spans, ``custereo.pyramid.pool``, ``.warp`` and
``.compose``: the pooling, the upsampling, rounding and warp of the
projector, and the composition to total disparities."""

GLUE = ("custereo.pyramid.pool", "custereo.pyramid.warp",
        "custereo.pyramid.compose")


def read(t):
    s = t.span_seconds(lambda name: name in GLUE)
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
