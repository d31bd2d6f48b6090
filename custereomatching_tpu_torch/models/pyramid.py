"""Coarse-to-fine pyramid stereo matcher (PyTorch port).

The counterpart of ``custereomatching_tpu/models/pyramid.py``: match at
1/f resolution over the full disparity range, then at full resolution over
a residual band of 2r + 1 disparities around the upsampled coarse
estimate, the projector warped per pixel so that the band is centred on
it.  Both levels run :meth:`StereoMatcher.disparity_maps` on the whole
batch, so on the ``cuda`` backend a call launches K3 twice: once on the
pooled pair, once on the warped pair.

The shifted pixels are selected by ``ops.consistency._select_shifted_f``:
one ``torch.gather`` with two masks where the JAX package makes
``hi - lo + 1`` where-passes (a TPU choice); the selection is exact.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.models.stereo import StereoMatcher
from custereomatching_tpu_torch.ops.consistency import (
    _select_shifted_f as _select_shifted,
)
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps
from custereomatching_tpu_torch.utils.profiling import span


def _avg_pool(img: torch.Tensor, f: int) -> torch.Tensor:
    """f x f mean pooling of ``[..., H, W]`` images, edge-padded to a
    multiple of f."""
    H, W = img.shape[-2:]
    ph, pw = (-H) % f, (-W) % f
    lead = img.shape[:-2]
    x = img.reshape((-1, 1, H, W))
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    Hp, Wp = H + ph, W + pw
    x = x.reshape(-1, Hp // f, f, Wp // f, f).mean(dim=(2, 4))
    return x.reshape(lead + (Hp // f, Wp // f))


def _upsample(x: torch.Tensor, f: int, H: int, W: int) -> torch.Tensor:
    """Nearest-neighbour f-fold upsampling of ``[..., h, w]`` maps, cropped
    to ``[..., H, W]``: one copy of the expanded maps."""
    *lead, h, w = x.shape
    up = x[..., :, None, :, None].expand(*lead, h, f, w, f)
    return up.reshape(*lead, h * f, w * f)[..., :H, :W]


def _warp_projector(projector: torch.Tensor, shift: torch.Tensor, lo: int,
                    hi: int) -> torch.Tensor:
    """``out[..., y, x] = projector[..., y, x - shift[..., y, x]]``, zero
    where the source column is out of view; ``shift`` integer-valued in
    ``[lo, hi]``."""
    return _select_shifted(projector, shift, lo, hi)


@dataclasses.dataclass(frozen=True)
class PyramidStereoMatcher:
    """Two-level coarse-to-fine matcher built on :class:`StereoMatcher`.

    Attributes:
      config: full-resolution configuration (``num_disparities`` the full
        search range D; banded only).
      downsample: the coarse level's reduction factor f (a range of
        ``ceil(D / f)`` at 1/f^2 of the pixels).
      residual: half-width r of the fine level's band (``[-r, r]`` around
        the upsampled coarse estimate).
    """

    config: StereoConfig = StereoConfig(num_disparities=192)
    downsample: int = 4
    residual: int = 12

    def __post_init__(self):
        if self.config.num_disparities is None:
            raise ValueError("pyramid matching requires banded mode")

    @functools.cached_property
    def _coarse(self) -> StereoMatcher:
        c = self.config
        d_coarse = -(-c.num_disparities // self.downsample)
        # Threshold -1: an all-ones mask, so the warp gets the raw soft
        # estimate everywhere.
        return StereoMatcher(dataclasses.replace(
            c, num_disparities=d_coarse, cost_threshold=-1.0))

    @functools.cached_property
    def _fine(self) -> StereoMatcher:
        return StereoMatcher(dataclasses.replace(
            self.config, num_disparities=2 * self.residual))

    def coarse_pair(self, camera: torch.Tensor, projector: torch.Tensor):
        """The coarse level's inputs: both images f x f mean-pooled (the
        span ``custereo.pyramid.pool``)."""
        f = self.downsample
        with span("custereo.pyramid.pool"):
            return _avg_pool(camera, f), _avg_pool(projector, f)

    def warp(self, projector: torch.Tensor, coarse_soft: torch.Tensor):
        """``(shift, warped projector)`` of the fine level: the shift
        ``round(d_up) - r`` (clamped to ``[-r, D]``) that centres the fine
        band ``[0, 2r]`` on the upsampled coarse estimate ``d_up``, and the
        projector read at ``x - shift``.  The shift is computed at the
        coarse resolution and then upsampled: the same values, each pass
        but the last over 1/f^2 of the pixels.  The span
        ``custereo.pyramid.warp``."""
        H, W = projector.shape[-2:]
        f, r = self.downsample, self.residual
        D = self.config.num_disparities
        with span("custereo.pyramid.warp"):
            shift = torch.clamp(torch.round(coarse_soft * f) - r, -r, D)
            shift = _upsample(shift, f, H, W)
            return shift, _warp_projector(projector, shift, -r, D)

    def compose(self, fine: PipelineMaps, shift: torch.Tensor
                ) -> PipelineMaps:
        """The fine level's maps to full disparities.  Band index d at
        pixel x read proj_w[x - d] = proj[x - d - shift(x - d)]: the total
        disparity is d + shift(x - d).  Negative disparities are physically
        invalid: they are clamped and lose their confidence.  The hard and
        soft maps go through each step together, stacked.  The span
        ``custereo.pyramid.compose``."""
        r = self.residual
        with span("custereo.pyramid.compose"):
            d_res = torch.stack((fine.disparity, fine.soft_disparity))
            shift_at = _select_shifted(shift.expand_as(d_res),
                                       torch.round(d_res), 0, 2 * r)
            total = (shift_at + d_res) * fine.mask
            mask = torch.where((total < 0).any(0), 0.0, fine.mask)
            hard, soft = (torch.clamp_min(total, 0.0) * mask).unbind(0)
            return PipelineMaps(disparity=hard, soft_disparity=soft,
                                mask=mask, confidence=fine.confidence)

    def __call__(self, camera: torch.Tensor,
                 projector: torch.Tensor) -> PipelineMaps:
        """Batched ``[B, H, W]`` pair to disparity maps: the coarse level on
        the pooled pair, the fine level on the camera and the warped
        projector, each one :meth:`StereoMatcher.disparity_maps` call.  The
        call is the span ``custereo.model.pyramid``, which encloses the
        glue's spans and both levels' ``custereo.model.disparity_maps``."""
        with span("custereo.model.pyramid"):
            coarse = self._coarse.disparity_maps(
                *self.coarse_pair(camera, projector))
            shift, proj_w = self.warp(projector, coarse.soft_disparity)
            return self.compose(self._fine.disparity_maps(camera, proj_w),
                                shift)
