"""The plain two-level coarse-to-fine matcher, one frame at a time.

The reference of the ``middlebury2014`` configuration, written from the
published algorithm on top of :mod:`zncc` (it imports nothing of the
port).  For a ``[H, W]`` pair, a full range D, a factor f and a band
half-width r:

  * pooling: f x f means, the frame edge-padded (its last row and column
    repeated) to a multiple of f;
  * the coarse level: the banded volume and head over ``ceil(D / f)``
    disparities on the pooled pair, threshold -1, so every pixel keeps its
    soft estimate;
  * ``d_up``: the coarse soft disparity repeated f times along both axes
    (nearest), cropped to the frame, times f;
  * ``shift = clamp(round(d_up) - r, -r, D)``, rounded half to even;
  * the warped projector ``proj_w[y, x] = proj[y, x - shift[y, x]]``, zero
    where ``x - shift`` is out of view;
  * the fine level: the banded volume and head over the band of 2r + 1
    planes on the camera and ``proj_w``, at the configuration's threshold;
  * composition: band index d at pixel x read projector column
    ``x - d - shift[x - d]``, so the total disparity is ``d + shift[x -
    round(d)]`` (shift 0 where ``x - round(d)`` is out of view); hard and
    soft totals are masked, a pixel whose total is negative loses its mask,
    and both are clamped at 0.

Maps come in the program's format (:class:`Maps`: disparity and soft
disparity masked, the mask as 0 / 1 in the input's dtype).  Every function
computes in the dtype of its inputs: float64 for the reference, bfloat16
for the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereobench.reference import zncc


class Maps(NamedTuple):
    disparity: torch.Tensor        # [H, W] hard disparity, masked
    soft_disparity: torch.Tensor   # [H, W] soft disparity, masked
    mask: torch.Tensor             # [H, W] 0 / 1
    confidence: torch.Tensor       # [H, W] largest cost


class Coarse(NamedTuple):
    head: zncc.Head                # the coarse level's head on the pooled pair
    d_up: torch.Tensor             # [H, W] f times the upsampled soft estimate
    shift: torch.Tensor            # [H, W] the fine band's offset


class Frame(NamedTuple):
    coarse: Coarse
    fine: Maps                     # the fine level over the band
    maps: Maps                     # the composition: total disparities


def coarse_config(config: dict) -> dict:
    """The coarse level's configuration: ``ceil(D / f)`` disparities and an
    all-ones mask."""
    f = int(config["downsample"])
    return dict(config, num_disparities=-(-int(config["num_disparities"])
                                          // f),
                cost_threshold=-1.0)


def fine_config(config: dict) -> dict:
    """The fine level's configuration: the band of 2r + 1 planes."""
    return dict(config, num_disparities=2 * int(config["residual"]))


def pool(img: torch.Tensor, f: int) -> torch.Tensor:
    """f x f means of an ``[H, W]`` image, edge-padded to a multiple of f."""
    H, W = img.shape
    ph, pw = (-H) % f, (-W) % f
    x = torch.cat([img, img[-1:].expand(ph, W)], dim=0)
    x = torch.cat([x, x[:, -1:].expand(H + ph, pw)], dim=1)
    return x.reshape((H + ph) // f, f, (W + pw) // f, f).mean(dim=(1, 3))


def maps_of(h: zncc.Head) -> Maps:
    """A banded head's maps in the program's format."""
    m = h.mask.to(h.soft.dtype)
    return Maps(disparity=h.index.to(h.soft.dtype) * m,
                soft_disparity=h.soft * m, mask=m, confidence=h.confidence)


def coarse(cam: torch.Tensor, proj: torch.Tensor, config: dict) -> Coarse:
    """The coarse level of one pair and the shift it gives the fine one."""
    H, W = cam.shape
    f, r = int(config["downsample"]), int(config["residual"])
    D = int(config["num_disparities"])
    cfg = coarse_config(config)
    h = zncc.head(zncc.volume(pool(cam, f), pool(proj, f), cfg), cfg)
    soft = maps_of(h).soft_disparity
    d_up = soft.repeat_interleave(f, 0).repeat_interleave(f, 1)[:H, :W] * f
    shift = torch.clamp(torch.round(d_up) - r, -r, D)
    return Coarse(head=h, d_up=d_up, shift=shift)


def _at(img: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``img[y, x - offset[y, x]]``, zero where the column is out of view
    (``offset`` integer-valued)."""
    W = img.shape[-1]
    cols = torch.arange(W, device=img.device) - offset.to(torch.int64)
    inside = (cols >= 0) & (cols < W)
    picked = torch.gather(img, -1, cols.clamp(0, W - 1))
    return torch.where(inside, picked, torch.zeros_like(picked))


def warp(proj: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The projector read at ``x - shift``, zero out of view."""
    return _at(proj, shift)


def compose(fine: Maps, shift: torch.Tensor) -> Maps:
    """The fine level's maps to total disparities (module docstring)."""
    def total(d):
        return _at(shift.to(d.dtype), torch.round(d)) + d

    hard = total(fine.disparity) * fine.mask
    soft = total(fine.soft_disparity) * fine.mask
    mask = fine.mask * ((hard >= 0) & (soft >= 0)).to(fine.mask.dtype)
    return Maps(disparity=hard.clamp_min(0) * mask,
                soft_disparity=soft.clamp_min(0) * mask, mask=mask,
                confidence=fine.confidence)


def fine(cam: torch.Tensor, proj: torch.Tensor, shift: torch.Tensor,
         config: dict):
    """``(fine level, composition)`` of one pair for a given ``shift``: the
    entry that holds a program's fine level to the reference on the
    program's own shift."""
    cfg = fine_config(config)
    level = maps_of(zncc.head(zncc.volume(cam, warp(proj, shift), cfg), cfg))
    return level, compose(level, shift)


def frame(cam: torch.Tensor, proj: torch.Tensor, config: dict) -> Frame:
    """The whole two-level algorithm on one ``[H, W]`` pair."""
    c = coarse(cam, proj, config)
    level, maps = fine(cam, proj, c.shift, config)
    return Frame(coarse=c, fine=level, maps=maps)
