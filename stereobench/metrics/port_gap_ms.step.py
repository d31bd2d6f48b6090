"""Device-idle time a unit that ends at a device operation whose launch
lies, on its own host thread, inside one of the port's spans
(``custereo.*``, at any depth of the chain that encloses it): the idle
that the port's own host code caused.  The gaps are those between the
merged busy intervals of the traced window, as the breakdown's; a gap
counts by the next operation's whole chain, not by its label."""

import bisect

from stereobench import tracing

PORT = "custereo."


def _ported(t, dev) -> bool:
    rt = t._launch(dev)
    return rt is not None and any(e["name"].startswith(PORT)
                                  for e in t._enclosing(rt))


def read(t):
    if t.units == 0 or not t.device or not any(
            e["name"].startswith(PORT) for evs in t._host.values()
            for e in evs):
        return None
    busy = tracing._merge(tracing._clip(
        [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
         for e in t.device], t.lo, t.hi))
    starts = sorted(t.device, key=lambda e: float(e["ts"]))
    keys = [float(e["ts"]) for e in starts]
    idle, edge = 0.0, t.lo
    for lo, hi in busy:
        if lo > edge and _ported(t, starts[bisect.bisect_left(keys, lo)]):
            idle += lo - edge
        edge = max(edge, hi)
    return 1e-3 * idle / t.units
