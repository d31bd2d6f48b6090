"""PyTorch port: the torch golden oracle (``ops.golden``) held against the
JAX package's golden oracle and the brute-force NumPy transliteration
(``tests/np_oracle.py``), and against the port's plain versions.

Forward rtol 1e-4 / atol 1e-5 (the JAX suite's); gradients rtol 1e-3 /
atol 1e-6 with cotangents at a mean loss's scale (1 / (H W)), the JAX
suite's gradient tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import golden as jax_golden
from custereomatching_tpu_torch.ops import golden
from custereomatching_tpu_torch.ops.zncc import (
    camera_grad_banded,
    forward_allpairs,
    forward_banded,
    projector_grad_banded,
)
from tests.np_oracle import zncc_brute

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)


def _pair(H=8, W=10, seed=0):
    rng = np.random.default_rng(seed)
    cam = rng.uniform(size=(H, W)).astype(np.float32)
    proj = rng.uniform(size=(H, W)).astype(np.float32)
    return cam, proj


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("D", [None, 0, 3, 7])
def test_forward_matches_jax_and_brute_force(k, D):
    cam, proj = _pair(H=7, W=9, seed=k + (D or 0))
    got = golden.zncc_cost_volume(_t(cam), _t(proj), D, k).numpy()
    assert got.shape == ((7, 9, 9) if D is None else (7, 9, D + 1))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, zncc_brute(cam, proj, k,
                                               num_disparities=D), **FWD)
    want = np.asarray(jax_golden.zncc_cost_volume(
        jnp.asarray(cam), jnp.asarray(proj), D, k))
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("D", [None, 0, 3, 7])
@pytest.mark.parametrize("wrt", ["camera", "projector"])
def test_grads_match_jax(k, D, wrt):
    H, W = 8, 10
    cam, proj = _pair(H, W, seed=10 + k)
    L = W if D is None else D + 1
    g = (np.random.default_rng(k).standard_normal((H, W, L))
         / (H * W)).astype(np.float32)
    ours = {"camera": golden.zncc_camera_grad,
            "projector": golden.zncc_projector_grad}[wrt]
    theirs = {"camera": jax_golden.zncc_camera_grad,
              "projector": jax_golden.zncc_projector_grad}[wrt]
    got = ours(_t(cam), _t(proj), _t(g), D, k).numpy()
    assert got.shape == (H, W) and np.isfinite(got).all()
    want = np.asarray(theirs(jnp.asarray(cam), jnp.asarray(proj),
                             jnp.asarray(g), D, k))
    np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize("k,D", [(3, 4), (5, 7), (7, 12)])
def test_oracle_agrees_with_plain_versions(k, D):
    """The direct patch sum against the port's moments-form plain
    versions: banded and all-pairs volumes, camera and projector VJPs."""
    H, W = 12, 20
    cam, proj = _pair(H, W, seed=20 + k)
    c, p = _t(cam), _t(proj)
    vol = golden.zncc_cost_volume(c, p, D, k)
    torch.testing.assert_close(forward_banded(c[None], p[None], D, k)[0],
                               vol, **FWD)
    torch.testing.assert_close(forward_allpairs(c[None], p[None], k)[0],
                               golden.zncc_cost_volume(c, p, None, k), **FWD)
    g = _t((np.random.default_rng(k).standard_normal((H, W, D + 1))
            / (H * W)).astype(np.float32))
    torch.testing.assert_close(
        camera_grad_banded(c[None], p[None], g[None], D, k)[0],
        golden.zncc_camera_grad(c, p, g, D, k), **GRAD)
    torch.testing.assert_close(
        projector_grad_banded(c[None], p[None], vol[None], g[None], D, k)[0],
        golden.zncc_projector_grad(c, p, g, D, k), **GRAD)


def test_banded_is_band_of_allpairs():
    cam, proj = _pair(H=6, W=8, seed=2)
    D = 4
    ap = golden.zncc_cost_volume(_t(cam), _t(proj), None, 3).numpy()
    bd = golden.zncc_cost_volume(_t(cam), _t(proj), D, 3).numpy()
    for w in range(8):
        for d in range(D + 1):
            if w - d >= 0:
                np.testing.assert_allclose(bd[:, w, d], ap[:, w, w - d],
                                           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_patch_extraction_equals_jax(k):
    img = np.arange(20, dtype=np.float32).reshape(4, 5)
    patches = golden.extract_patches(_t(img), k)
    assert patches.shape == (4, 5, k * k)
    np.testing.assert_array_equal(
        patches.numpy(),
        np.asarray(jax_golden.extract_patches(jnp.asarray(img), k)))
    # the centre offset reproduces the image; the top-left offset of
    # pixel (0, 0) is out of bounds, so zero
    np.testing.assert_array_equal(patches[..., (k * k) // 2].numpy(), img)
    if k > 1:
        assert patches[0, 0, 0] == 0.0
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        golden.extract_patches(_t(img)[None], k)


def test_oracle_refuses_tf32(monkeypatch):
    """The oracle sums in full fp32: a TF32 matmul setting raises."""
    cam, proj = _pair()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        golden.zncc_cost_volume(_t(cam), _t(proj), None, 3)


def test_shape_mismatch_raises():
    cam, proj = _pair()
    with pytest.raises(ValueError, match="must match"):
        golden.zncc_cost_volume(_t(cam), _t(proj)[:, :-1], 3, 3)
