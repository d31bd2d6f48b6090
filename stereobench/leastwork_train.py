"""The least work of a train step's backward, beside the whole step's.

:func:`leastwork.train_step` counts a camera-optimisation step; a reader
of the backward's share needs the backward alone, and a reader gets
nothing but the work its loop hands over.  So the loop hands over a
:class:`StepWork`, the step's work with the backward's beside it.

The backward's least work is every entry's cotangent and camera VJP at
``leastwork.py``'s frozen counts (``COTANGENT_FLOPS + vjp_flops(k)``);
it reads the camera, the projector and the soft disparity's cotangent
and writes the gradient.  Whether the costs are read back or recomputed
is a choice of the kernels, not of the function, so it counts neither.
"""

from __future__ import annotations

from stereobench import leastwork


class StepWork(leastwork.Work):
    """:func:`leastwork.train_step`'s work; ``backward`` its backward's."""


def backward(config: dict, frames: int) -> leastwork.Work:
    k = int(config["kernel_size"])
    px = frames * int(config["height"]) * int(config["width"])
    return leastwork.Work(
        flops=float((leastwork.COTANGENT_FLOPS + leastwork.vjp_flops(k))
                    * leastwork.entries(config, frames)),
        bytes=float(4 * px * 4))


def train_step(config: dict, frames: int) -> StepWork:
    work = StepWork(*leastwork.train_step(config, frames))
    work.backward = backward(config, frames)
    return work
