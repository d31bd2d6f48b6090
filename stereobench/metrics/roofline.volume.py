"""A step's least-work time over the device's kernel time a step
(``leastwork.train_step``), through ``StereoMatcher.__call__``: how near
K1, K8h, K8hb and K2 run to the card's published peaks together, whatever
kernels they are."""

from stereobench import harness

read = harness.reader("roofline.step")
