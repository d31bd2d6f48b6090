"""Drivers of the traffic mixes, one module a ``loop`` name."""
