"""The least work of each cell's function, and the card's published peaks.

A frozen copy of the least-work arithmetic of the port's
``utils/profiling.py`` (``cost_flops``, ``HEAD_FLOPS``,
``COTANGENT_FLOPS``, ``vjp_flops`` and the data sheet's peaks), so that a
later change that fuses, splits or replaces a kernel is measured against
the same work.  What is counted is the function and not any kernel:

  * every entry of the volume (a pixel and a plane, or a pixel and a
    projector column) once, with its window sums taken separably;
  * each input byte read once and each output byte written once;
  * intermediates (the volume, the head's sums, the cotangent) nothing.

``tests/test_stereobench_leastwork.py`` holds these counts to the port's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

# Published peaks (NVIDIA's data sheet, SXM part at 700 W): fp32 outside
# the tensor cores and the HBM rate, by the name
# torch.cuda.get_device_name() gives.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "bytes": 3.35e12},
}

HEAD_FLOPS = 6        # max, argmax, e^{beta c}, s += u, t += d u
COTANGENT_FLOPS = 8   # the head's cotangent of one entry
# A pixel of the loss, (soft * mask - target)^2 summed, and its cotangent
# 2 (soft - target) / n.
LOSS_FLOPS = 5
# A pixel of Adam: m (3), v (3), the bias-corrected denominator (3: sqrt,
# scale, + eps) and the update (3: divide, scale, subtract).
ADAM_FLOPS = 12


def cost_flops(k: int) -> int:
    """One entry's cost: its product, the window's 2k taps, then
    ``(sxy - mux sy + eps) r`` with ``r = rsqrt(ex2 ey2 + eps)``: 7."""
    return 2 * k + 8


def vjp_flops(k: int) -> int:
    """One entry's share of the camera VJP: ``gr = g r``, the window of
    gr (2k taps), ``A1 += box proj`` and the B and GRMU sums."""
    return 2 * k + 9


class Work(NamedTuple):
    flops: float
    bytes: float

    def seconds(self, peaks: Dict[str, float]) -> float:
        """The least time at ``peaks``: the larger of operations over the
        fp32 rate and bytes over the memory rate."""
        return max(self.flops / peaks["flops"], self.bytes / peaks["bytes"])


def entries(config: dict, frames: int) -> int:
    """Entries of the configuration's volume over ``frames`` frames."""
    H, W = int(config["height"]), int(config["width"])
    D = config["num_disparities"]
    return frames * H * W * (W if D is None else int(D) + 1)


def maps(config: dict, frames: int) -> Work:
    """The four maps of ``frames`` frames: cost and head of every entry;
    the two images read, the four maps written."""
    k = int(config["kernel_size"])
    px = frames * int(config["height"]) * int(config["width"])
    return Work(flops=float((cost_flops(k) + HEAD_FLOPS)
                            * entries(config, frames)),
                bytes=float(4 * px * 6))


def train_step(config: dict, frames: int) -> Work:
    """One camera-optimisation step over ``frames`` frames: the maps'
    work, the cotangent and camera VJP of every entry, the loss and Adam
    at every pixel; read the camera, projector, target and Adam's two
    moments, write the camera and the two moments."""
    k = int(config["kernel_size"])
    px = frames * int(config["height"]) * int(config["width"])
    per_entry = cost_flops(k) + HEAD_FLOPS + COTANGENT_FLOPS + vjp_flops(k)
    return Work(flops=float(per_entry * entries(config, frames)
                            + (LOSS_FLOPS + ADAM_FLOPS) * px),
                bytes=float(4 * px * 8))


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card, or None for a card without them."""
    return PEAKS.get(device_name)
