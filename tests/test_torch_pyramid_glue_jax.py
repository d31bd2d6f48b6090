"""PyTorch port, the pyramid's glue against the JAX package's: the plain
twins of K11p / K11w / K11c's one-pass arithmetic (in
``test_torch_pyramid_glue.py``) and the port's plain glue, held frame by
frame against ``custereomatching_tpu.models.pyramid.PyramidStereoMatcher.
_single``.  Its two levels are stood in for by the maps of each case, so
the JAX pool, shift, warp and composition run as the matcher runs them:
shifts at both clamp ends, columns out of view on both sides, band
indices outside [0, 2r], a negative total in one map only, NaN in the
coarse and the fine soft maps.  The composition's cases take f = 1 and a
coarse soft map of ``shift + r``, so that ``_single`` makes the case's
shift itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models import pyramid as jax_pyramid
from custereomatching_tpu.ops.pallas_pipeline import PipelineMaps as JaxMaps
from custereomatching_tpu_torch.models import pyramid
from tests.test_torch_pyramid_glue import (
    COMPOSE_CASES,
    POOL_CASES,
    POOL_TOL,
    WARP_CASES,
    _bit_equal,
    _compose_inputs,
    _pool_inputs,
    _warp_inputs,
    compose_twin,
    pool_twin,
    warp_twin,
)


class _Level:
    """A matcher level that returns the maps it was given and keeps the
    pair it was called with."""

    def __init__(self, maps: JaxMaps):
        self.maps, self.pair = maps, None

    def disparity_maps(self, camera, projector):
        self.pair = (camera, projector)
        return self.maps


@pytest.fixture
def jax_single(monkeypatch):
    """``run(camera, projector, coarse_soft, fine, f, r, D)`` on one
    ``[H, W]`` frame: ``_single`` with its levels stood in for, returning
    the pooled pair, the shift, the warped projector and the composed maps
    as torch tensors."""
    shifts = []
    warp = jax_pyramid._warp_projector

    def recording(projector, shift, lo, hi):
        shifts.append(shift)
        return warp(projector, shift, lo, hi)

    monkeypatch.setattr(jax_pyramid, "_warp_projector", recording)

    def run(camera, projector, coarse_soft, fine, f, r, D):
        pyr = jax_pyramid.PyramidStereoMatcher(
            StereoConfig(num_disparities=D), downsample=f, residual=r)
        zeros = jnp.zeros((1,) + tuple(coarse_soft.shape), jnp.float32)
        coarse = _Level(JaxMaps(zeros, jnp.asarray(coarse_soft.numpy())[None],
                                zeros, zeros))
        fine_level = _Level(JaxMaps(*(jnp.asarray(m.numpy())[None]
                                      for m in fine)))
        # The levels are cached properties: the instance's dict wins.
        pyr.__dict__.update(_coarse=coarse, _fine=fine_level)
        shifts.clear()
        maps = pyr._single(jnp.asarray(camera.numpy()),
                           jnp.asarray(projector.numpy()))

        def t(x):
            return torch.from_numpy(np.array(x))

        (shift,) = shifts
        return ((t(coarse.pair[0][0]), t(coarse.pair[1][0])), t(shift),
                t(fine_level.pair[1][0]), tuple(t(m) for m in maps))

    return run


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN where the other has NaN, every other value exactly.  A zero's
    sign may differ: ``jnp.maximum(-0.0, 0.0)`` is +0.0 where torch's
    ``clamp_min`` (the port's, and the kernel's bit for bit) keeps -0.0."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _zero_fine(H, W):
    return tuple(torch.zeros((H, W)) for _ in range(4))


@pytest.mark.parametrize("port", ["twin", "plain"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool_matches_jax(jax_single, case, port):
    """The pooled pair the coarse level gets, within rtol 1e-6 (the order
    of each block's sum)."""
    B, H, W, f = case
    cam, proj = _pool_inputs(case)
    pool = pool_twin if port == "twin" else pyramid._avg_pool
    got = pool(cam, f), pool(proj, f)
    coarse = torch.zeros((-(-H // f), -(-W // f)))
    for b in range(B):
        want, *_ = jax_single(cam[b], proj[b], coarse, _zero_fine(H, W),
                              f, 1, 8)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[b], w, **POOL_TOL)


@pytest.mark.parametrize("port", ["twin", "plain"])
@pytest.mark.parametrize("case", WARP_CASES, ids=str)
def test_warp_matches_jax(jax_single, case, port):
    """The shift (NaN where JAX has NaN, ``_same``) and the warped
    projector, bit for bit: both clamp ends, both sides out of view, and a
    NaN shift, which reads the projector's own column in both."""
    B, H, W, f, r, D = case
    proj, coarse = _warp_inputs(case)
    if port == "twin":
        shift, proj_w = warp_twin(proj, coarse, f, r, D)
    else:
        shift, proj_w = pyramid._shift_and_warp(proj, coarse, f, r, D)
    for b in range(B):
        _, j_shift, j_proj_w, _ = jax_single(proj[b], proj[b], coarse[b],
                                             _zero_fine(H, W), f, r, D)
        assert _same(shift[b], j_shift)
        assert _bit_equal(proj_w[b], j_proj_w)
    assert torch.isnan(shift).any()
    assert (shift == -r).any() and (shift == D).any()


@pytest.mark.parametrize("port", ["twin", "plain"])
@pytest.mark.parametrize("case", COMPOSE_CASES, ids=str)
def test_compose_matches_jax(jax_single, case, port):
    """The composed maps, NaN where JAX has NaN and every other value
    exactly (``_same``): band indices outside [0, 2r], columns out of
    view, negative totals in one map only, NaN in the soft map."""
    B, H, W, r = case
    fine, shift = _compose_inputs(case)
    D = 3 * r
    assert float(shift.min()) >= -r and float(shift.max()) <= D
    compose = compose_twin if port == "twin" else pyramid._compose
    got = compose(fine, shift, r)
    for b in range(B):
        cam = torch.zeros((H, W))
        _, j_shift, _, want = jax_single(cam, cam, shift[b] + r,
                                         tuple(m[b] for m in fine), 1, r, D)
        assert _bit_equal(j_shift, shift[b])
        for g, w in zip(got, want):
            assert _same(g[b], w)
    assert torch.isnan(got.soft_disparity).any()
