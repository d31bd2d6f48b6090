"""PyTorch port: the pyramid matcher (``models/pyramid.py``) held against
the JAX package's on the CPU."""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import PyramidStereoMatcher as JaxPyramid
from custereomatching_tpu.models.pyramid import _avg_pool as jax_avg_pool
from custereomatching_tpu.models.pyramid import _upsample as jax_upsample
from custereomatching_tpu_torch import StereoConfig, config_from_jax
from custereomatching_tpu_torch.data.synthetic import (
    render_camera,
    slanted_plane_disparity,
    speckle_pattern,
)
from custereomatching_tpu_torch.models import PyramidStereoMatcher
from custereomatching_tpu_torch.models.pyramid import _avg_pool, _upsample
from custereomatching_tpu_torch.ops.zncc import forward_banded
from custereomatching_tpu_torch.utils import disparity_metrics
from custereomatching_tpu_torch.utils.profiling import COUNTS


@pytest.mark.parametrize("shape,f", [((4, 4), 2), ((10, 23), 4),
                                     ((3, 9, 14), 3)])
def test_avg_pool_matches_jax(shape, f):
    """f x f means, edge-padded to a multiple of f, frame by frame."""
    x = np.random.default_rng(f).random(shape, dtype=np.float32)
    got = _avg_pool(torch.from_numpy(x), f).numpy()
    frames = x.reshape((-1,) + shape[-2:])
    want = np.stack([np.asarray(jax_avg_pool(jnp.asarray(fr), f))
                     for fr in frames]).reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_upsample_equals_jax():
    x = np.random.default_rng(3).random((2, 5, 7), dtype=np.float32)
    got = _upsample(torch.from_numpy(x), 4, 18, 27).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_upsample(jnp.asarray(x[b]), 4, 18, 27)))


def _multi_octave(H, W, seed=0):
    """The texture of tests/test_pyramid.py: speckle at three scales."""
    p1 = speckle_pattern(H, W, seed=seed)
    p2 = speckle_pattern(H, W, dot_density=0.02, dot_sigma=4.0, seed=seed + 1)
    p3 = speckle_pattern(H, W, dot_density=0.005, dot_sigma=12.0,
                         seed=seed + 2)
    return (0.4 * p1 + 0.35 * p2 + 0.25 * p3).astype(np.float32)


def _near_boundaries(jpyr, cam, proj):
    """Pixels where a rounding in the JAX pyramid is within 1e-4 of a
    half-integer (the coarse estimate d_up, or the fine level's soft and
    hard residual), or the fine level's top two costs lie within 1e-5: at
    those a last-bit difference may move the hard disparity or the mask.
    Recomputed from the JAX matcher's own levels."""
    from custereomatching_tpu.models.pyramid import (
        _select_shifted as jsel,
    )
    H, W = cam.shape
    f, r, D = jpyr.downsample, jpyr.residual, jpyr.config.num_disparities
    coarse = jpyr._coarse.disparity_maps(
        jax_avg_pool(jnp.asarray(cam), f)[None],
        jax_avg_pool(jnp.asarray(proj), f)[None])
    d_up = np.asarray(jax_upsample(coarse.soft_disparity[0], f, H, W)) * f
    shift = np.clip(np.round(d_up) - r, -r, D)
    proj_w = np.array(jsel(jnp.asarray(proj), jnp.asarray(shift), -r, D))
    fine = jpyr._fine.disparity_maps(jnp.asarray(cam)[None],
                                     jnp.asarray(proj_w)[None])
    d_res = np.asarray(fine.soft_disparity[0])

    def half(x):
        return np.abs(np.abs(x - np.floor(x)) - 0.5) <= 1e-4

    cost = forward_banded(torch.from_numpy(cam)[None],
                          torch.from_numpy(proj_w)[None], 2 * r,
                          jpyr.config.kernel_size)[0]
    top2 = torch.topk(cost, 2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-5).numpy()
    return half(d_up) | half(d_res) | tie


def _hold(got, jpyr, cam, proj, soft_tol):
    """The port's first frame against the JAX pyramid ``jpyr``: hard
    disparity and mask equal but at pixels within 1e-4 of a rounding
    boundary or with a top-two tie (counted and printed), confidence within
    rtol 1e-4 / atol 1e-5 and soft disparity within ``soft_tol`` elsewhere."""
    want = jpyr(jnp.asarray(cam)[None], jnp.asarray(proj)[None])
    skip = _near_boundaries(jpyr, cam, proj)
    hard_diff = got.disparity[0].numpy() != np.asarray(want.disparity[0])
    mask_diff = got.mask[0].numpy() != np.asarray(want.mask[0])
    excused = int((skip & (hard_diff | mask_diff)).sum())
    print(f"pyramid {jpyr.config.backend}: {int(skip.sum())} pixels near a "
          f"rounding boundary or a tie, {excused} of them differing")
    assert not (~skip & (hard_diff | mask_diff)).any()
    keep = ~skip & ~mask_diff
    np.testing.assert_allclose(got.confidence[0].numpy()[keep],
                               np.asarray(want.confidence[0])[keep],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.soft_disparity[0].numpy()[keep],
                               np.asarray(want.soft_disparity[0])[keep],
                               **soft_tol)


@pytest.mark.parametrize("backend,H,W,D,K,f,r", [
    ("xla", 96, 256, 48, 11, 4, 8),
    ("pallas_interpret", 48, 128, 16, 7, 2, 4),
])
def test_pyramid_matches_jax(backend, H, W, D, K, f, r):
    """The two configurations of tests/test_pyramid.py:47-77, built on both
    sides from one config, downsample and residual, held to the JAX
    pyramid by :func:`_hold`: against its XLA levels with the soft
    disparity within rtol 1e-4 / atol 1e-5; against the fused kernel's
    levels (``pallas_interpret``) within the JAX suite's head tolerance,
    rtol / atol 1e-3, because those run the kernel's online softmax
    (tests/test_pallas_zncc.py holds it to the plain head so), and the
    same inputs also against the XLA levels at 1e-4 / 1e-5.  The port
    runs its plain K3 at both levels, each once for the whole batch, and
    passes the JAX test's accuracy floors."""
    proj = _multi_octave(H, W, seed=0 if backend == "xla" else 5)
    dtrue = slanted_plane_disparity(H, W, d_min=4 if backend == "xla" else 2,
                                    d_max=40 if backend == "xla" else 12)
    cam = render_camera(proj, dtrue, noise=0.005 if backend == "xla" else 0.0)
    jcfg = JaxStereoConfig(kernel_size=K, num_disparities=D, backend=backend)
    pyr = PyramidStereoMatcher(config_from_jax(dataclasses.asdict(jcfg)),
                               downsample=f, residual=r)
    both = (torch.from_numpy(np.stack([cam, cam])),
            torch.from_numpy(np.stack([proj, proj])))
    before = COUNTS.copy()
    got = pyr(*both)
    assert COUNTS - before == Counter({"plain.stereo_pipeline_reference": 2,
                                       "plain.forward_banded": 2})
    torch.testing.assert_close(got.soft_disparity[0], got.soft_disparity[1],
                               rtol=0, atol=0)
    xla = dict(rtol=1e-4, atol=1e-5)
    if backend != "xla":
        _hold(got, JaxPyramid(jcfg, downsample=f, residual=r), cam, proj,
              dict(rtol=1e-3, atol=1e-3))
    _hold(got, JaxPyramid(dataclasses.replace(jcfg, backend="xla"),
                          downsample=f, residual=r), cam, proj, xla)
    m = disparity_metrics(got.soft_disparity[0], torch.from_numpy(dtrue),
                          got.mask[0])
    assert m["coverage"] > (0.9 if backend == "xla" else 0.8)
    assert m["epe"] < 1.5
    if backend == "xla":
        assert m["bad3"] < 0.05


def test_pyramid_requires_banded():
    with pytest.raises(ValueError, match="banded"):
        PyramidStereoMatcher(StereoConfig(num_disparities=None))


def test_pyramid_levels_match_jax_config():
    """The coarse level searches ceil(D / f) with an all-ones mask, the
    fine level 2r, as the JAX matcher's levels."""
    jpyr = JaxPyramid(JaxStereoConfig(num_disparities=190), downsample=4,
                      residual=12)
    pyr = PyramidStereoMatcher(StereoConfig(num_disparities=190))
    assert (pyr.downsample, pyr.residual) == (jpyr.downsample, jpyr.residual)
    for level in ("_coarse", "_fine"):
        got, want = getattr(pyr, level).config, getattr(jpyr, level).config
        assert got.num_disparities == want.num_disparities
        assert got.cost_threshold == want.cost_threshold
    assert pyr._coarse.config.num_disparities == 48
