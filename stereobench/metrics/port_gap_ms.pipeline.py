"""Device-idle time a call of the stream that ends at a device operation
launched inside one of the port's spans: ``port_gap_ms.step``'s reading,
a call a unit."""

from stereobench import harness

read = harness.reader("port_gap_ms.step")
