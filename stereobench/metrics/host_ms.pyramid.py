"""Host time a call of the port's span ``custereo.model.pyramid``: how long
the host takes to enqueue one pyramid call (both levels and the glue
between them), whatever the device does meanwhile."""

SPAN = "custereo.model.pyramid"


def read(t):
    us = [float(e["dur"]) for evs in t._host.values() for e in evs
          if e["name"] == SPAN and t.lo <= float(e["ts"]) <= t.hi]
    if not us or t.units == 0:
        return None
    return 1e-3 * sum(us) / t.units
