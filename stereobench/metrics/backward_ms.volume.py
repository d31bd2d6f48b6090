"""Device time a step of the kernels launched by the autograd engine's
backward (its ``evaluate_function`` spans) through
``StereoMatcher.__call__``: K8hb, the head's VJP, then K2, the volume's
camera VJP."""

from stereobench import harness

read = harness.reader("backward_ms.step")
