"""PyTorch port, all-pairs slice: the plain all-pairs volume (K8's twin),
its closed-form camera VJP (K8b's twin), the K8 and K8b wrappers' CPU
paths and the default (all-pairs) StereoMatcher, held against the JAX package on the CPU (its
Pallas kernel in interpret mode, its XLA op and its model)."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_allpairs import (
    pallas_cost_volume_allpairs,
    stereo_matching_pallas_allpairs,
)
from custereomatching_tpu_torch import StereoConfig, StereoMatcher
from custereomatching_tpu_torch import config_from_jax
from custereomatching_tpu_torch.ops import stereo_matching
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    CudaAllPairsMatching,
    camera_grad_allpairs_cuda,
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.zncc import (
    _hankel_cols,
    _image_moments,
    box2d,
    box_rows,
    camera_grad_allpairs,
    forward_allpairs,
    stereo_matching_torch,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS

# The JAX suite's all-pairs forward tolerance
# (tests/test_pallas_allpairs.py:39-40): the summation orders differ and
# A - Sx Sy / k^2 cancels, so both packages agree to ~1e-6 (standard
# normal inputs).
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# The JAX suite's gradient tolerance (tests/test_pallas_bwd.py:89).
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def _pair(seed, *shape, normal=True):
    rng = np.random.default_rng(seed)
    draw = rng.standard_normal if normal else rng.random
    return (draw(shape).astype(np.float32), draw(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [
    (24, 60, 5),      # the shapes of tests/test_pallas_allpairs.py:28-31
    (16, 150, 15),
    (13, 40, 7),
    (9, 129, 3),
])
def test_forward_allpairs_matches_jax(shape):
    H, W, K = shape
    cam, proj = _pair(0, H, W)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    wants = (pallas_cost_volume_allpairs(jcam, jproj, K, 1e-8, 8, True),
             jax_zncc._forward_allpairs(jcam, jproj, K, 1e-8, "highest"))
    got = forward_allpairs(torch.from_numpy(cam)[None],
                           torch.from_numpy(proj)[None], K)[0]
    assert got.shape == (H, W, W)
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_box_rows_and_hankel_match_jax(k):
    x = np.random.default_rng(k).standard_normal((7, 11, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        box_rows(torch.from_numpy(x), k).numpy(),
        np.asarray(jax_zncc.box_rows(jnp.asarray(x), k)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(
        _hankel_cols(torch.from_numpy(x[0]), k).numpy(),
        np.asarray(jax_zncc._hankel_cols(jnp.asarray(x[0]), k)))


@pytest.mark.parametrize("shape", [(16, 40, 5), (12, 30, 9), (10, 12, 1)])
def test_public_allpairs_op_matches_xla_op(shape):
    """Forward through the public op (k = 1 kept on the plain path), single
    and batched."""
    H, W, K = shape
    cam, proj = _pair(1, H, W, normal=False)
    want = np.asarray(jax_zncc.stereo_matching(jnp.asarray(cam),
                                               jnp.asarray(proj), None, K))
    got = stereo_matching(torch.from_numpy(cam), torch.from_numpy(proj),
                          None, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    batched = stereo_matching_torch(torch.from_numpy(cam)[None],
                                    torch.from_numpy(proj)[None], None, K)
    torch.testing.assert_close(batched[0], got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(16, 40, 5), (16, 96, 9)])
def test_allpairs_camera_grad_matches_jax(shape):
    """The closed-form all-pairs VJP behind the plain node, against
    jax.grad of the XLA op and of the Pallas op; the projector gets no
    gradient."""
    H, W, K = shape
    cam, proj = _pair(3, H, W)
    g = np.random.default_rng(4).standard_normal((H, W, W)).astype(
        np.float32) / (H * W)
    jcam, jproj, jg = jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g)
    wants = [
        jax.grad(lambda c: jnp.sum(
            jax_zncc.stereo_matching(c, jproj, None, K) * jg))(jcam),
        jax.grad(lambda c: jnp.sum(stereo_matching_pallas_allpairs(
            c, jproj, K, 1e-8, True) * jg))(jcam)]

    cam_t = torch.from_numpy(cam).requires_grad_(True)
    proj_t = torch.from_numpy(proj).requires_grad_(True)
    before = COUNTS.copy()
    (stereo_matching(cam_t, proj_t, None, K) * torch.from_numpy(g)).sum() \
        .backward()
    assert COUNTS - before == Counter({"plain.forward_allpairs": 1,
                                       "plain.camera_grad_allpairs": 1})
    assert proj_t.grad is None
    for want in wants:
        np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


# (H, W, k) with k // 2 > W: shifts of the closed form's A1 sum that
# reach past the whole row.
WIDE_WINDOWS = [(17, 4, 21), (3, 3, 9), (9, 9, 21), (6, 12, 31)]


def _scaled(got, want, atol=GRAD_TOL["atol"]):
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale,
                               rtol=GRAD_TOL["rtol"], atol=atol)


@pytest.mark.parametrize("shape", WIDE_WINDOWS)
def test_allpairs_camera_grad_where_window_is_wider_than_image(shape):
    """A shift |p - j| >= W of the A1 sum reads no column (JAX pads E by p
    on both sides); the closed form returns JAX's gradient there."""
    H, W, K = shape
    cam, proj = _pair(10, H, W, normal=False)
    g = np.random.default_rng(11).standard_normal((H, W, W)).astype(
        np.float32)
    jproj, jg = jnp.asarray(proj), jnp.asarray(g)
    want = jax.grad(lambda c: jnp.sum(
        jax_zncc.stereo_matching(c, jproj, None, K) * jg))(jnp.asarray(cam))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    (stereo_matching(cam_t, torch.from_numpy(proj), None, K)
     * torch.from_numpy(g)).sum().backward()
    _scaled(cam_t.grad.numpy(), want)


def test_allpairs_model_backward_where_window_is_wider_than_image():
    """The default all-pairs matcher at k = 21 on a 2 x 9 x 9 batch:
    forward and the camera gradient of a mean soft-disparity loss against
    the JAX XLA model.  The gradient is held scaled at atol 5e-5 (the JAX
    sweep's, tests/test_fuzz_shapes.py:68): the soft-argmax at beta = 50
    lifts fp32 rounding, and this port's and JAX's gradients lie 3.5e-5
    and 1.4e-5 of the largest entry from the port's float64 run."""
    jmodel, model = _jax_model(kernel_size=21)
    assert model.config.backend == "torch"
    cam, proj = _pair(12, 2, 9, 9, normal=False)
    jproj = jnp.asarray(proj)

    def jloss(c):
        out = jmodel(c, jproj)
        return jnp.mean(out.soft_disparity), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(cam))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    got = model(cam_t, torch.from_numpy(proj))
    got.soft_disparity.mean().backward()
    np.testing.assert_allclose(got.cost_volume.detach().numpy(),
                               np.asarray(want.cost_volume), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.soft_disparity.detach().numpy(),
                               np.asarray(want.soft_disparity), rtol=1e-3,
                               atol=1e-3)
    _scaled(cam_t.grad.numpy(), jgrad, atol=5e-5)


def _camera_grad_unbounded_shifts(camera, projector, g, cost, k, eps=1e-8):
    """The closed form with the A1 shift loop unbounded, which is right
    where every shift lies inside the row (k // 2 < W)."""
    p = k // 2
    k2 = float(k * k)
    W = camera.shape[-1]
    sx, ex2 = _image_moments(camera, k)
    sy, ey2 = _image_moments(projector, k)
    mux = sx / k2
    muy = sy / k2
    r = torch.rsqrt(ex2[..., :, None] * ey2[..., None, :] + eps)
    gr = g * r
    b = torch.sum(g * cost * (r * r) * ey2[..., None, :], dim=-1)
    grmu = torch.sum(gr * muy[..., None, :], dim=-1)
    g2 = box_rows(gr, k, dim=-3)
    hp = _hankel_cols(projector, k)
    a1 = torch.zeros_like(camera)
    for j in range(k):
        e_j = torch.sum(g2 * hp[..., None, :, j], dim=-1)
        s = p - j
        if s >= 0:
            a1[..., :W - s] += e_j[..., s:]
        else:
            a1[..., -s:] += e_j[..., :W + s]
    return (a1 - box2d(grmu, k, dim=1) + box2d(b * mux, k, dim=1)
            - camera * box2d(b, k, dim=1))


@pytest.mark.parametrize("shape", [
    (24, 60, 5), (16, 150, 15), (13, 40, 7), (9, 129, 3), (16, 40, 5),
    (16, 96, 9), (12, 30, 9), (10, 12, 1), (12, 24, 5)])
def test_allpairs_camera_grad_unchanged_inside_the_row(shape):
    """Where every shift lies inside the row (the fixed shapes of this
    file), bounding the shifts changes no bit of the gradient."""
    H, W, K = shape
    cam, proj = (torch.from_numpy(a) for a in _pair(13, 2, H, W))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, H, W, W)).astype(np.float32))
    cost = forward_allpairs(cam, proj, K)
    assert torch.equal(camera_grad_allpairs(cam, proj, g, cost, K),
                       _camera_grad_unbounded_shifts(cam, proj, g, cost, K))


def test_camera_grad_allpairs_matches_autograd():
    """The closed form uses the cost residual (n r = c); it equals torch
    autograd of the moments-form forward."""
    B, H, W, K = 2, 12, 24, 5
    cam, proj = (torch.from_numpy(a) for a in _pair(5, B, H, W))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, H, W, W)).astype(np.float32))
    c = cam.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        (forward_allpairs(c, proj, K) * g).sum(), c)
    got = camera_grad_allpairs(cam, proj, g, forward_allpairs(cam, proj, K),
                               K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-4)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_k8_wrapper_cpu_takes_plain_version():
    B, H, W, K = 2, 9, 21, 3
    cam, proj = (torch.from_numpy(a) for a in _pair(7, B, H, W))
    before = COUNTS.copy()
    got = cost_volume_allpairs_cuda(cam, proj, K, precision="default")
    assert COUNTS - before == Counter({"plain.forward_allpairs": 1})
    torch.testing.assert_close(got, forward_allpairs(cam, proj, K), rtol=0,
                               atol=0)
    # The autograd node over the wrapper: the plain VJP, no projector grad.
    c = cam.clone().requires_grad_(True)
    p = proj.clone().requires_grad_(True)
    CudaAllPairsMatching.apply(c, p, K, 1e-8, "highest").sum().backward()
    assert p.grad is None
    want = camera_grad_allpairs(cam, proj, torch.ones((B, H, W, W)), got, K)
    torch.testing.assert_close(c.grad, want, rtol=0, atol=0)


def test_k8b_wrapper_cpu_takes_plain_version():
    """On CPU tensors K8b's wrapper is the plain closed form, bit for bit,
    whatever statistics it is handed (the plain version recomputes them),
    and counts no launch."""
    B, H, W, K = 2, 9, 21, 5
    cam, proj = (torch.from_numpy(a) for a in _pair(9, B, H, W))
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, H, W, W)).astype(np.float32))
    cost = forward_allpairs(cam, proj, K)
    before = COUNTS.copy()
    got = camera_grad_allpairs_cuda(cam, proj, g, cost, (), K)
    assert COUNTS - before == Counter({"plain.camera_grad_allpairs": 1})
    torch.testing.assert_close(got, camera_grad_allpairs(cam, proj, g, cost,
                                                         K), rtol=0, atol=0)


def test_k8b_wrapper_rejects_other_devices():
    """K8b runs on CUDA tensors, its plain version on CPU tensors; any
    other device raises, counting no launch."""
    B, H, W, K = 1, 6, 8, 3
    cam = torch.zeros((B, H, W), device="meta")
    vol = torch.zeros((B, H, W, W), device="meta")
    before = COUNTS.copy()
    with pytest.raises(ValueError, match="K8b runs on CUDA or"):
        camera_grad_allpairs_cuda(cam, cam, vol, vol, (cam,) * 4, K)
    assert COUNTS == before


@pytest.mark.parametrize("bad", [
    dict(kernel_size=4),
    dict(dtype=torch.float64),
    dict(shape=(5, 7)),                       # the wrapper takes [B, H, W]
    dict(precision="high"),
])
def test_k8_wrapper_rejects(bad):
    shape = bad.get("shape", (1, 5, 7))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError):
        cost_volume_allpairs_cuda(x, x, bad.get("kernel_size", 3),
                                  precision=bad.get("precision", "highest"))


def _jax_model(**kw):
    jcfg = JaxStereoConfig(backend="xla", **kw)
    return JaxStereoMatcher(jcfg), StereoMatcher(
        config_from_jax(dataclasses.asdict(jcfg)))


def test_default_model_is_allpairs_and_matches_jax():
    """StereoMatcher(StereoConfig()) runs: batched all-pairs volume, head
    and camera gradient of a mean soft-disparity loss against the JAX XLA
    model; disparity_maps takes the volume path on the torch backend."""
    assert StereoConfig().num_disparities is None
    B, H, W, K = 2, 12, 32, 5
    jmodel, model = _jax_model(kernel_size=K)
    cam, proj = _pair(8, B, H, W, normal=False)
    jproj = jnp.asarray(proj)

    def jloss(c):
        out = jmodel(c, jproj)
        return jnp.mean(out.soft_disparity), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(cam))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    got = model(cam_t, torch.from_numpy(proj))
    got.soft_disparity.mean().backward()
    assert got.cost_volume.shape == (B, H, W, W)
    np.testing.assert_allclose(got.cost_volume.detach().numpy(),
                               np.asarray(want.cost_volume), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.soft_disparity.detach().numpy(),
                               np.asarray(want.soft_disparity), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(jgrad),
                               **GRAD_TOL)

    maps = model.disparity_maps(torch.from_numpy(cam), torch.from_numpy(proj))
    jmaps = jmodel.disparity_maps(jnp.asarray(cam), jproj)
    np.testing.assert_array_equal(maps.disparity.numpy(),
                                  np.asarray(jmaps.disparity))
    np.testing.assert_allclose(maps.confidence.detach().numpy(),
                               np.asarray(jmaps.confidence), rtol=1e-5,
                               atol=1e-5)


def test_allpairs_trainable_maps_take_volume_path():
    """trainable_disparity_maps with all-pairs is the volume path and
    trains the camera, as in the JAX XLA model."""
    B, H, W, K = 1, 10, 24, 5
    jmodel, model = _jax_model(kernel_size=K)
    cam, proj = _pair(9, B, H, W, normal=False)
    jproj = jnp.asarray(proj)
    want = jax.grad(lambda c: jnp.mean(jmodel.trainable_disparity_maps(
        c, jproj).soft_disparity))(jnp.asarray(cam))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    model.trainable_disparity_maps(cam_t, torch.from_numpy(proj)) \
        .soft_disparity.mean().backward()
    np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(want),
                               **GRAD_TOL)


def test_cuda_backend_allpairs_routes(monkeypatch):
    """On the cuda backend, CPU tensors raise; the fused pipeline needs a
    banded config (the JAX Pallas backend's ValueError), checked with the
    backend resolved to cuda."""
    model = StereoMatcher(StereoConfig(kernel_size=3, backend="cuda"))
    x = torch.zeros((1, 6, 8))
    for fn in (model, model.cost_volume, model.disparity_maps):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, x)
    monkeypatch.setattr(StereoConfig, "resolved_backend",
                        lambda self, device: "cuda")
    with pytest.raises(ValueError, match="requires banded mode"):
        model.disparity_maps(x, x)
