"""The share of the traced window in which the card runs neither a kernel
nor a copy, while the camera is optimised through
``StereoMatcher.__call__``."""

from stereobench import harness

read = harness.reader("device_idle.step")
