"""A step's least-work time over the device's kernel time a step, over 15
Middlebury frames (``leastwork.train_step``): how near the kernels of the
volume-free step, K3m, K5 and what surrounds them, run to the card's
published peaks, whatever kernels they are."""

from stereobench import harness

read = harness.reader("roofline.step")
