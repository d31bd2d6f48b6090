"""PyTorch port: the disparity head against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import disparity as jax_disparity
from custereomatching_tpu_torch.ops.disparity import (
    disparity_to_depth,
    extract_disparity,
    soft_argmax,
)


def _assert_result_close(got, want):
    for name in ("disparity", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("soft_disparity", "confidence"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_disparities", [None, 7])
def test_extract_disparity_matches_jax(num_disparities):
    """Banded (band index = disparity) and all-pairs (w - column)."""
    H, W = 6, 8
    L = W if num_disparities is None else num_disparities + 1
    cv = np.random.default_rng(0).uniform(-1, 1, (H, W, L)).astype(
        np.float32)
    want = jax_disparity.extract_disparity(
        jnp.asarray(cv), num_disparities=num_disparities, threshold=0.6,
        beta=50.0)
    got = extract_disparity(torch.from_numpy(cv), num_disparities, 0.6, 50.0)
    _assert_result_close(got, want)
    batched = extract_disparity(torch.from_numpy(cv)[None].repeat(2, 1, 1, 1),
                                num_disparities, 0.6, 50.0)
    for name in got._fields:
        torch.testing.assert_close(getattr(batched, name)[1],
                                   getattr(got, name), rtol=0, atol=0)


def test_first_max_ties():
    """torch.argmax takes the first maximum, as jnp.argmax does."""
    cv = np.zeros((2, 3, 5), np.float32)
    cv[0, 0, [1, 3]] = 0.9           # two-way tie: disparity 1
    cv[0, 1, :] = 0.8                # all tied: disparity 0
    cv[1, 2, [2, 4]] = 0.7           # tie at the last band: disparity 2
    want = jax_disparity.extract_disparity(jnp.asarray(cv),
                                           num_disparities=4)
    got = extract_disparity(torch.from_numpy(cv), 4)
    _assert_result_close(got, want)
    assert got.disparity[0, 0] == 1 and got.disparity[1, 2] == 2
    assert got.disparity[0, 1] == 0 and got.mask[0, 1] == 1


def test_extract_disparity_rejects_bad_volumes():
    with pytest.raises(ValueError):
        extract_disparity(torch.zeros(4, 5), 3)
    with pytest.raises(ValueError, match="num_disparities"):
        extract_disparity(torch.zeros(2, 3, 5), 6)


@pytest.mark.parametrize("dim", [0, -1])
def test_soft_argmax_matches_jax(dim):
    x = np.random.default_rng(1).standard_normal((5, 9)).astype(np.float32)
    want = np.asarray(jax_disparity.soft_argmax(jnp.asarray(x), beta=3.0,
                                                axis=dim))
    got = soft_argmax(torch.from_numpy(x), beta=3.0, dim=dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_disparity_to_depth_matches_jax():
    d = np.array([[0.0, 1e-4, 2.0], [4.0, 0.5, 64.0]], np.float32)
    want = np.asarray(jax_disparity.disparity_to_depth(jnp.asarray(d), 700.0,
                                                       0.1))
    got = disparity_to_depth(torch.from_numpy(d), 700.0, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
