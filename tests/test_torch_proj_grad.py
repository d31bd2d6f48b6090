"""PyTorch port, projector-gradient slice: the closed-form projector VJP
(K7's twin), the K7 wrapper's CPU path, ``stereo_matching_with_proj_grad``
and ``StereoMatcher(grad_projector=True)``, held against the JAX package on
the CPU (its Pallas kernels in interpret mode, its golden oracle, its XLA
op and model); and the port's verify example."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.models.optimize import (
    disparity_loss as jax_disparity_loss,
)
from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.golden import zncc_projector_grad
from custereomatching_tpu.ops.pallas_zncc import (
    pallas_cost_volume_banded_hdw,
)
from custereomatching_tpu.ops.pallas_zncc_bwd import (
    pallas_projector_grad_banded_hdw_with_cost,
)
from custereomatching_tpu_torch import StereoMatcher, config_from_jax
from custereomatching_tpu_torch.examples import verify as verify_example
from custereomatching_tpu_torch.models.optimize import disparity_loss
from custereomatching_tpu_torch.ops import stereo_matching
from custereomatching_tpu_torch.ops.cuda_zncc import (
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.zncc import (
    forward_banded,
    projector_grad_banded,
    stereo_matching_with_proj_grad,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS

# The JAX suite's gradient tolerance (tests/test_pallas_bwd.py:89).
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


@pytest.mark.parametrize("shape", [
    (16, 24, 5, 3, 16),    # the shapes of tests/test_pallas_bwd.py:277-281
    (24, 150, 10, 5, 8),
    (40, 96, 12, 15, 16),
])
def test_projector_grad_matches_jax(shape):
    """The closed form on the same cost and cotangent against the Pallas
    projector kernel (interpret mode), the golden oracle's autodiff and
    torch autograd of the plain forward.  The cotangent is at a mean
    loss's scale (1 / (H W)), the regime of the JAX gradient tolerance."""
    H, W, D, K, hb = shape
    cam, proj = _pair(3, H, W)
    g = (np.random.default_rng(4).standard_normal((D + 1, H, W))
         / (H * W)).astype(np.float32)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    vol = pallas_cost_volume_banded_hdw(jcam, jproj, D, K, 1e-8, hb, 8, True,
                                        True)
    gp = np.zeros(vol.shape, np.float32)
    gp[:D + 1, :H, :W] = g
    g_hwd = np.ascontiguousarray(np.transpose(g, (1, 2, 0)))
    wants = [
        pallas_projector_grad_banded_hdw_with_cost(
            jcam, jproj, vol, jnp.asarray(gp), D, K, 1e-8, hb, 8, True),
        zncc_projector_grad(jcam, jproj, jnp.asarray(g_hwd), D, K)]

    cam_t, proj_t = torch.from_numpy(cam)[None], torch.from_numpy(proj)[None]
    g_t = torch.from_numpy(g_hwd)[None]
    got = projector_grad_banded(cam_t, proj_t,
                                forward_banded(cam_t, proj_t, D, K), g_t, D,
                                K)[0].numpy()
    p = proj_t.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        (forward_banded(cam_t, p, D, K) * g_t).sum(), p)
    wants.append(auto[0])
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)


def test_k7_wrapper_cpu_takes_plain_version():
    B, H, W, D, K = 2, 12, 30, 5, 3
    cam, proj = (torch.from_numpy(a) for a in _pair(5, B, H, W))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, D + 1, H, W)).astype(np.float32))
    cost = forward_banded(cam, proj, D, K).permute(0, 3, 1, 2)
    before = COUNTS.copy()
    got = projector_grad_banded_cuda(cam, proj, cost, g, D, K)
    assert COUNTS - before == Counter({"plain.projector_grad_banded": 1})
    want = projector_grad_banded(cam, proj, cost.permute(0, 2, 3, 1),
                                 g.permute(0, 2, 3, 1), D, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="plane-major"):
        projector_grad_banded_cuda(cam, proj, cost, g[:, :-1], D, K)
    with pytest.raises(ValueError, match="kernel_size"):
        projector_grad_banded_cuda(cam, proj, cost, g, D, 1)


@pytest.mark.parametrize("mode,k", [("allpairs", 3), ("banded", 3),
                                    ("banded", 5), ("banded", 1),
                                    ("allpairs", 1)])
def test_with_proj_grad_matches_jax(mode, k):
    """Both gradients of the both-images op against the JAX op
    (tests/test_zncc_op.py:84-100).  k = 1 is kept: its volume is the pure
    eps artefact eps / sqrt(eps) in both packages, and its gradients are
    fp32 rounding amplified by r = eps^{-1/2} (finite, not comparable)."""
    H, W = 10, 12
    D = None if mode == "allpairs" else 4
    cam, proj = _pair(7, H, W)
    L = W if D is None else D + 1
    g = np.random.default_rng(8).standard_normal((H, W, L)).astype(
        np.float32)
    jg = jnp.asarray(g)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    want = jax.grad(lambda c, p: jnp.sum(
        jax_zncc.stereo_matching_with_proj_grad(c, p, D, k) * jg),
        argnums=(0, 1))(jcam, jproj)
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    proj_t = torch.from_numpy(proj).requires_grad_(True)
    cost = stereo_matching(cam_t, proj_t, D, k, grad_projector=True)
    assert cost.shape == (H, W, L)
    np.testing.assert_allclose(
        cost.detach().numpy(),
        np.asarray(jax_zncc.stereo_matching_with_proj_grad(jcam, jproj, D,
                                                           k)),
        rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        stereo_matching_with_proj_grad(cam_t[None], proj_t[None], D, k)[0],
        cost, rtol=0, atol=0)
    (cost * torch.from_numpy(g)).sum().backward()
    if k == 1:
        assert bool(torch.isfinite(cam_t.grad).all()
                    and torch.isfinite(proj_t.grad).all())
        return
    # Scaled by max |want|, then the JAX suite's own tolerance for this op
    # (tests/test_zncc_op.py:96-100): a unit-scale cotangent, where a raw
    # atol of 1e-6 is below fp32 rounding of the gradient.
    for got, w in zip((cam_t.grad, proj_t.grad), want):
        scale = float(jnp.max(jnp.abs(w))) + 1e-6
        np.testing.assert_allclose(got.numpy() / scale, np.asarray(w) / scale,
                                   rtol=1e-3, atol=2e-4)


def _models(**kw):
    jcfg = JaxStereoConfig(backend="xla", grad_projector=True, **kw)
    return JaxStereoMatcher(jcfg), StereoMatcher(
        config_from_jax(dataclasses.asdict(jcfg)))


@pytest.mark.parametrize("D", [6, None])
def test_grad_projector_model_matches_jax(D):
    """StereoMatcher(grad_projector=True), batched: the volume and both
    gradients of a mean soft-disparity loss against the JAX XLA model."""
    B, H, W, K = 2, 12, 32, 5
    jmodel, model = _models(kernel_size=K, num_disparities=D)
    cam, proj = _pair(9, B, H, W)

    def jloss(c, p):
        out = jmodel(c, p)
        return jnp.mean(out.soft_disparity), out.cost_volume

    (_, jvol), (jgc, jgp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(cam), jnp.asarray(proj))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    proj_t = torch.from_numpy(proj).requires_grad_(True)
    out = model(cam_t, proj_t)
    out.soft_disparity.mean().backward()
    np.testing.assert_allclose(out.cost_volume.detach().numpy(),
                               np.asarray(jvol), rtol=1e-4, atol=1e-5)
    assert float(proj_t.grad.abs().max()) > 0
    np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(jgc),
                               **GRAD_TOL)
    np.testing.assert_allclose(proj_t.grad.numpy(), np.asarray(jgp),
                               **GRAD_TOL)


def test_grad_projector_loss_moves_projector():
    """disparity_loss honours grad_projector (tests/test_zncc_op.py:
    183-199): the projector gradient is nonzero, finite and the JAX one;
    trainable_disparity_maps takes the volume path."""
    B, H, W, K, D = 1, 12, 16, 5, 6
    jmodel, model = _models(kernel_size=K, num_disparities=D)
    cam, proj = _pair(10, B, H, W)
    target = np.zeros((B, H, W), np.float32)
    want = jax.grad(lambda p: jax_disparity_loss(
        jmodel, jnp.asarray(cam), p, jnp.asarray(target)))(jnp.asarray(proj))
    proj_t = torch.from_numpy(proj).requires_grad_(True)
    disparity_loss(model, torch.from_numpy(cam), proj_t,
                   torch.from_numpy(target)).backward()
    got = proj_t.grad.numpy()
    assert np.abs(got).max() > 0 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)

    proj_m = torch.from_numpy(proj).requires_grad_(True)
    model.trainable_disparity_maps(torch.from_numpy(cam), proj_m) \
        .soft_disparity.mean().backward()
    assert float(proj_m.grad.abs().max()) > 0


def test_camera_only_default_gives_no_projector_grad():
    model = StereoMatcher(config_from_jax({"kernel_size": 3,
                                           "num_disparities": 2}))
    cam, proj = (torch.from_numpy(a)[None] for a in _pair(11, 6, 8))
    proj.requires_grad_(True)
    cam.requires_grad_(True)
    model(cam, proj).soft_disparity.sum().backward()
    assert proj.grad is None and cam.grad is not None


def test_verify_example_passes_on_cpu(capsys):
    assert verify_example.main(["--height", "16", "--width", "32", "-D",
                                "6", "-k", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "VERIFY: PASS" in out and "FAIL" not in out
    assert "K7 vs plain" in out and "K8 vs plain" in out
