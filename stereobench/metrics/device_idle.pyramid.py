"""The share of the traced window in which the card runs neither a kernel
nor a copy, while frames stream through the pyramid."""

from stereobench import harness

read = harness.reader("device_idle.pipeline")
