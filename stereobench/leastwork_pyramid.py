"""The least work of the coarse-to-fine matcher's function.

What is counted is the function of the two levels, at ``leastwork.py``'s
frozen per-entry counts, and not any kernel:

  * every entry of both levels once, at ``cost_flops(k) + HEAD_FLOPS``:
    the coarse level's ``ceil(H/f) x ceil(W/f)`` pixels over ``ceil(D/f)
    + 1`` planes, the fine level's ``H x W`` pixels over the band's 2r + 1;
  * the two full-resolution images read once and the four maps written
    once;
  * intermediates (the pooled pair, the coarse maps, the shift, the warped
    projector, the fine level's maps) nothing.
"""

from __future__ import annotations

from typing import Tuple

from stereobench import leastwork


def levels(config: dict) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """``((h, w, D), ...)`` of the coarse and the fine level: each level's
    frame and its largest disparity (planes ``D + 1``)."""
    H, W = int(config["height"]), int(config["width"])
    f, r = int(config["downsample"]), int(config["residual"])
    D = int(config["num_disparities"])
    return (-(-H // f), -(-W // f), -(-D // f)), (H, W, 2 * r)


def maps(config: dict, frames: int) -> leastwork.Work:
    """The four maps of ``frames`` frames through both levels."""
    k = int(config["kernel_size"])
    px = frames * int(config["height"]) * int(config["width"])
    entries = frames * sum(h * w * (d + 1) for h, w, d in levels(config))
    return leastwork.Work(
        flops=float((leastwork.cost_flops(k) + leastwork.HEAD_FLOPS)
                    * entries),
        bytes=float(4 * px * 6))
