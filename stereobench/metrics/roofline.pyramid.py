"""The frames' least-work time through both levels over the device's
kernel time (``leastwork_pyramid.maps``): how near the kernels that make
the maps, K3 at both levels and the glue's, run to the card's published
peaks, whatever kernels they are."""

from stereobench import harness

read = harness.reader("roofline.pipeline")
