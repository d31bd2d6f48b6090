"""Faults planted under the timed path, to show that the comparison
catches them: each is a context manager that patches the port while it
is open.  ``tests/test_stereobench_faults.py`` runs cells with each on
the CPU; ``tools/calibrate.py --faults`` reads them on the card.

  * ``unchanged``: a train step that leaves the camera and Adam's state
    as they were (the optimizer's step does nothing);
  * ``half_batch``: a train step whose loss is the mean over the first
    half of the batch alone;
  * ``ascent``: a train step whose optimizer climbs the loss (Adam's
    ``maximize``): the update's size is right, its sign wrong;
  * ``altered``: one pixel of the soft disparity moved by half a pixel
    where the maps are produced (every matcher path).

A cell on one card has no exchange between chips, so that fault has no
place here.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged():
    from custereomatching_tpu_torch.models import optimize

    def make(original):
        def make_train_step(model, mesh=None):
            step = original(model, mesh)

            def broken(state, projector, target):
                opt = state.optimizer
                opt.step = lambda *a, **k: None
                try:
                    return step(state, projector, target)
                finally:
                    del opt.step
            return broken
        return make_train_step

    return _patched(optimize, "make_train_step", make)


def ascent():
    from custereomatching_tpu_torch.models import optimize

    def make(original):
        def make_train_step(model, mesh=None):
            step = original(model, mesh)

            def broken(state, projector, target):
                for group in state.optimizer.param_groups:
                    group["maximize"] = True
                return step(state, projector, target)
            return broken
        return make_train_step

    return _patched(optimize, "make_train_step", make)


def half_batch():
    from custereomatching_tpu_torch.models import optimize

    def make(original):
        def disparity_loss(model, camera, projector, target, mesh=None):
            h = max(1, camera.shape[0] // 2)
            return original(model, camera[:h], projector[:h], target[:h],
                            mesh)
        return disparity_loss

    return _patched(optimize, "disparity_loss", make)


def _alter(maps):
    soft = maps.soft_disparity
    i = (0, soft.shape[-2] // 2, soft.shape[-1] // 2)
    bump = torch.zeros_like(soft)
    bump[i] = 0.5
    return maps._replace(soft_disparity=soft + bump)


@contextlib.contextmanager
def altered():
    from custereomatching_tpu_torch.models.stereo import StereoMatcher

    def make(original):
        def method(self, *args, **kwargs):
            return _alter(original(self, *args, **kwargs))
        return method

    with contextlib.ExitStack() as stack:
        for name in ("disparity_maps", "trainable_disparity_maps",
                     "disparity"):
            stack.enter_context(_patched(StereoMatcher, name, make))
        yield


FAULTS = {"unchanged": unchanged, "ascent": ascent,
          "half_batch": half_batch, "altered": altered}
