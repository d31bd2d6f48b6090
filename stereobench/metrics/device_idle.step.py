"""The share of the traced window in which the card runs neither a kernel
nor a copy, while the camera is optimised."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
