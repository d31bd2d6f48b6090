"""A step's least operations over what the card's fp32 peak could do in
the whole traced window, idle time included."""


def read(t):
    if t.peaks is None or t.window_s <= 0 or t.units == 0:
        return None
    return 100.0 * t.units * t.work.flops / (t.window_s * t.peaks["flops"])
