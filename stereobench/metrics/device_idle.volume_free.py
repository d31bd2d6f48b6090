"""The share of the traced window in which the card runs neither a kernel
nor a copy, while 15 Middlebury frames are trained without their cost
volume."""

from stereobench import harness

read = harness.reader("device_idle.step")
