"""Camera optimisation over frames whose cost volume no card holds:
``loops/train.py``'s closed loop, judged in row bands.

The step, the state, the recorded steps, the window and the traced
stretch are ``train.run``'s: ``make_train_step`` over the whole batch,
whose ``trainable_disparity_maps`` chooses the program's own path for
the size (at 15 Middlebury frames, the volume-free K3m and K5).  Two
things differ.  The recorded steps are judged by
:func:`checks_volume_free.judge` (the reference in row bands, gradients
on frames drawn from the seed) in place of :func:`checks.judge_train`,
which is patched for the run as ``faults.py`` patches the port.  And the
least work handed to the readers carries the backward's
(:func:`leastwork_train.train_step`).
"""

from __future__ import annotations

import contextlib
import functools

from stereobench import checks, checks_volume_free, harness, leastwork_train
from stereobench.loops import train


@contextlib.contextmanager
def judged_in_bands(seed: int):
    original = checks.judge_train
    checks.judge_train = functools.partial(checks_volume_free.judge,
                                           seed=seed)
    try:
        yield
    finally:
        checks.judge_train = original


def run(r: harness.Run) -> harness.Outcome:
    with judged_in_bands(r.seed):
        out = train.run(r)
    cfg = r.cell.config
    return out._replace(work=leastwork_train.train_step(
        cfg, int(cfg["frames_per_call"])))
