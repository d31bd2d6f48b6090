"""Device time a step of the kernels and copies launched inside the
port's span ``custereo.train.loss``, the forward of a train step: K3w and
its statistics pass and the loss at KITTI, K8, the plain head and the
loss in the speckle cell."""


def read(t):
    s = t.span_seconds(lambda name: name == "custereo.train.loss")
    if s is None or t.units == 0:
        return None
    return 1e3 * s / t.units
