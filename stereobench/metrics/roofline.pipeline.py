"""The frames' least-work time over the device's kernel time: how near
the kernels that make the maps run to the card's published peaks,
whatever kernels they are (``leastwork.maps``)."""


def read(t):
    if t.peaks is None or t.kernel_s <= 0 or t.units == 0:
        return None
    return 100.0 * t.units * t.work.seconds(t.peaks) / t.kernel_s
