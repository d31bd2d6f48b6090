"""PyTorch port: the left-right consistency check (``ops/consistency.py``),
the exact shifted selection it gathers with (``models/pyramid.py``),
``StereoMatcher.disparity_maps_lr`` and the engine's ``lr_check``, held
against the JAX package on the CPU."""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.data import make_stereo_pair as jax_make_pair
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.models.engine import StereoEngine as JaxEngine
from custereomatching_tpu.models.pyramid import (
    _select_shifted as jax_select_shifted,
)
from custereomatching_tpu.ops import consistency as jax_consistency
from custereomatching_tpu_torch import (
    StereoConfig,
    StereoEngine,
    StereoMatcher,
    config_from_jax,
)
from custereomatching_tpu_torch.data import make_stereo_pair
from custereomatching_tpu_torch.models.pyramid import _select_shifted
from custereomatching_tpu_torch.ops import consistency
from custereomatching_tpu_torch.utils import disparity_metrics
from custereomatching_tpu_torch.utils.profiling import COUNTS


@pytest.mark.parametrize("lo,hi", [(-3, 5), (0, 16), (-12, 40)])
def test_select_shifted_equals_jax(lo, hi):
    """The one-gather selection equals JAX's where-select pass exactly: out
    of view columns and shifts outside [lo, hi] give zero, shifts are cut
    toward zero to integers, and a batch selects frame by frame."""
    rng = np.random.default_rng(hi)
    src = rng.standard_normal((3, 10, 40)).astype(np.float32)
    k = rng.integers(lo - 4, hi + 5, (3, 10, 40)).astype(np.float32)
    k[0, :2] += rng.uniform(-0.9, 0.9, (2, 40)).astype(np.float32)
    got = _select_shifted(torch.from_numpy(src), torch.from_numpy(k), lo, hi)
    for b in range(3):
        want = np.asarray(jax_select_shifted(jnp.asarray(src[b]),
                                             jnp.asarray(k[b]), lo, hi))
        np.testing.assert_array_equal(got[b].numpy(), want)
    cols = np.arange(40)[None, None, :] - k.astype(np.int64)
    outside = (cols < 0) | (cols >= 40) | (k.astype(np.int64) < lo) | (
        k.astype(np.int64) > hi)
    assert outside.any() and (~outside).any()
    assert not got.numpy()[outside].any()


@pytest.mark.parametrize("tolerance", [0.5, 1.0, 2.0])
def test_lr_consistency_mask_equals_jax(tolerance):
    """The mask, frame by frame, equals JAX's (``jnp.round`` and
    ``torch.round`` both round half to even), with left disparities that
    point out of view or past D."""
    rng = np.random.default_rng(int(10 * tolerance))
    D = 12
    left = rng.uniform(-2, D + 3, (2, 16, 48)).astype(np.float32)
    left[0, 0, :6] = [0.5, 1.5, 2.5, 3.5, -0.5, 12.5]
    right = (left + rng.normal(0, 1.0, left.shape)).astype(np.float32)
    got = consistency.lr_consistency_mask(torch.from_numpy(left),
                                          torch.from_numpy(right), D,
                                          tolerance)
    for b in range(2):
        want = np.asarray(jax_consistency.lr_consistency_mask(
            jnp.asarray(left[b]), jnp.asarray(right[b]), D, tolerance))
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert 0 < float(got.mean()) < 1


def test_flip_helpers_equal_jax():
    rng = np.random.default_rng(2)
    cam, proj = (rng.random((6, 9), dtype=np.float32) for _ in range(2))
    got = consistency.matched_pair_right(torch.from_numpy(cam),
                                         torch.from_numpy(proj))
    want = jax_consistency.matched_pair_right(jnp.asarray(cam),
                                              jnp.asarray(proj))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        consistency.flip_back(torch.from_numpy(cam)).numpy(),
        np.asarray(jax_consistency.flip_back(jnp.asarray(cam))))


def _box_pair(B, H, W, d_min, d_max, seed):
    pairs = [make_stereo_pair(H, W, scene="box", d_min=d_min, d_max=d_max,
                              noise=0.01, seed=seed + b) for b in range(B)]
    return [np.stack(x) for x in zip(*pairs)]


@pytest.mark.parametrize("backend,shape", [
    ("xla", (1, 64, 128, 16, 9)),
    ("pallas_interpret", (2, 32, 64, 8, 5)),
])
def test_disparity_maps_lr_matches_jax(backend, shape):
    """``disparity_maps_lr`` on the port's plain versions against the JAX
    matcher (XLA, and the fused kernel in interpret mode) on the box scene:
    the consistency mask and the hard disparity equal, the soft disparity
    and confidence within the JAX suite's head tolerances."""
    B, H, W, D, K = shape
    cam, proj, _ = _box_pair(B, H, W, 3.0, D - 4.0, 0)
    jcfg = JaxStereoConfig(kernel_size=K, num_disparities=D, backend=backend)
    want = JaxStereoMatcher(jcfg).disparity_maps_lr(jnp.asarray(cam),
                                                    jnp.asarray(proj))
    model = StereoMatcher(config_from_jax(dataclasses.asdict(jcfg)))
    before = COUNTS.copy()
    got = model.disparity_maps_lr(torch.from_numpy(cam),
                                  torch.from_numpy(proj))
    assert COUNTS - before == Counter({"plain.stereo_pipeline_reference": 2,
                                       "plain.forward_banded": 2})
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(want.confidence), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.soft_disparity.numpy(),
                               np.asarray(want.soft_disparity), rtol=1e-3,
                               atol=1e-3)
    plain = model.disparity_maps(torch.from_numpy(cam),
                                 torch.from_numpy(proj))
    assert float(got.mask.sum()) < float(plain.mask.sum())


def test_allpairs_disparity_maps_lr_matches_jax():
    """All-pairs checks shifts up to W - 1 and takes the volume path on the
    plain backend, as the JAX XLA matcher does."""
    H, W, K = 12, 24, 5
    cam, proj, _ = _box_pair(1, H, W, 2.0, 6.0, 3)
    jcfg = JaxStereoConfig(kernel_size=K, backend="xla")
    want = JaxStereoMatcher(jcfg).disparity_maps_lr(jnp.asarray(cam),
                                                    jnp.asarray(proj))
    got = StereoMatcher(config_from_jax(dataclasses.asdict(
        jcfg))).disparity_maps_lr(torch.from_numpy(cam),
                                  torch.from_numpy(proj))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.soft_disparity.numpy(),
                               np.asarray(want.soft_disparity), rtol=1e-3,
                               atol=1e-3)


def test_lr_consistency_improves_occlusions():
    """The floors of ``tests/test_pyramid.py::
    test_lr_consistency_improves_occlusions`` on the port: left-right
    checking lowers EPE and bad3 among the surviving pixels of the box
    scene and keeps over 80% of them; the port's scene is JAX's."""
    cam, proj, dtrue = make_stereo_pair(64, 128, scene="box", d_min=3,
                                        d_max=12, noise=0.01, seed=0)
    for g, w in zip((cam, proj, dtrue),
                    jax_make_pair(64, 128, scene="box", d_min=3, d_max=12,
                                  noise=0.01, seed=0)):
        np.testing.assert_array_equal(g, np.asarray(w))
    model = StereoMatcher(StereoConfig(kernel_size=9, num_disparities=16))
    camb, projb = torch.from_numpy(cam)[None], torch.from_numpy(proj)[None]
    plain = model.disparity_maps(camb, projb)
    lr = model.disparity_maps_lr(camb, projb, tolerance=1.0)
    truth = torch.from_numpy(dtrue)
    mp = disparity_metrics(plain.soft_disparity[0], truth, plain.mask[0])
    ml = disparity_metrics(lr.soft_disparity[0], truth, lr.mask[0])
    assert ml["epe"] < mp["epe"]
    assert ml["bad3"] < mp["bad3"]
    assert ml["coverage"] > 0.8


def test_engine_lr_check_matches_jax_engine():
    """``StereoEngine(lr_check=True)`` serves ``disparity_maps_lr``: the
    port's engine on the CPU against the JAX engine (XLA) on a padded
    frame, and equal to the matcher's maps on the unpadded frame."""
    cfg = JaxStereoConfig(kernel_size=5, num_disparities=8, backend="xla")
    cam, proj, _ = _box_pair(1, 24, 48, 2.0, 5.0, 7)
    jeng = JaxEngine(cfg, buckets=[(32, 64)], lr_check=True)
    want = jeng.infer(cam[0], proj[0])
    eng = StereoEngine(config_from_jax(dataclasses.asdict(cfg)),
                       buckets=[(32, 64)], lr_check=True, device="cpu")
    eng.warmup()
    got = eng.infer(cam[0], proj[0])
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_array_equal(got.disparity, np.asarray(want.disparity))
    np.testing.assert_allclose(got.soft_disparity,
                               np.asarray(want.soft_disparity), rtol=1e-3,
                               atol=1e-3)
    direct = eng.model.disparity_maps_lr(torch.from_numpy(cam),
                                         torch.from_numpy(proj))
    np.testing.assert_array_equal(got.mask, direct.mask[0].numpy())
