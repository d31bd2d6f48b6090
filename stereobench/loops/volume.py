"""Camera optimisation through the flagship ``StereoMatcher.__call__``:
``loops/train.py``'s closed loop with the matcher's trainable maps taken
from its volume path.

Each step is ``make_train_step``'s (the loss, ``backward()`` and Adam's
step), its maps the soft disparity of ``StereoMatcher.__call__``: on the
``cuda`` backend K1's plane-major volume and K8h over it, backward K8hb
into that layout and K2 (the path ``grad_projector`` and all-pairs
configurations train through; a banded camera-only one would take the
fused pipeline).  The function is ``loops/train.py``'s, so the same
reference and :func:`checks.judge_train` judge it.  The matcher is
``train.recording_matcher``'s subclass with ``trainable_disparity_maps``
sent to ``_volume_maps``, put in ``train.run``'s place for the run.
"""

from __future__ import annotations

import contextlib

from stereobench import harness
from stereobench.loops import train

recording_matcher = train.recording_matcher


def volume_matcher(config):
    """``train.recording_matcher(config)`` whose trainable maps are
    ``StereoMatcher.__call__``'s (recorded where its head runs)."""
    recording = type(recording_matcher(config))

    class Volume(recording):
        def trainable_disparity_maps(self, camera, projector):
            return self._volume_maps(camera, projector)

    return Volume(config)


@contextlib.contextmanager
def through_the_volume():
    train.recording_matcher = volume_matcher
    try:
        yield
    finally:
        train.recording_matcher = recording_matcher


def run(r: harness.Run) -> harness.Outcome:
    with through_the_volume():
        return train.run(r)
