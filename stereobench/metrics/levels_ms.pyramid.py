"""Device time a call of the kernels and copies launched inside a level's
``custereo.model.disparity_maps`` within ``custereo.model.pyramid``: K3
and its statistics pass at the coarse and the fine level."""

PYRAMID = "custereo.model.pyramid"
LEVEL = "custereo.model.disparity_maps"


def read(t):
    if t.units == 0 or not any(e["name"] == PYRAMID
                               for evs in t._host.values() for e in evs):
        return None
    total = 0.0
    for dev in t.device:
        rt = t._launch(dev)
        if rt is None:
            continue
        names = {e["name"] for e in t._enclosing(rt)}
        if PYRAMID in names and LEVEL in names:
            total += float(dev["dur"])
    return 1e-3 * total / t.units
