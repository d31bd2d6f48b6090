"""Kernel launches a step, counted in the device trace."""


def read(t):
    if t.units == 0 or not t.device:
        return None
    return t.launches / t.units
