"""The tiny CPU sizes of the cells added after ``tests/tiny.py`` was
written, put beside its own before any test module is collected (the
fault tests list their cases while they are imported)."""

from stereobench.tests import tiny

tiny.SIZES.setdefault("middlebury2014", dict(
    height=19, width=41, num_disparities=13, kernel_size=5, downsample=2,
    residual=3, frames_per_call=1,
    scene=dict(tiny.SCENE, d_min=3.0, d_max=10.0)))
