"""PyTorch port, the volume-free slice: the camera VJP without the cost
residual (K6, both entries), the volume-free trainable pipeline (K3m and
K5) and the plane-major volume op, held against the JAX package on the CPU
(its Pallas kernels in interpret mode).  CPU tensors take the kernels'
plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import extract_disparity_hdw as jax_head_hdw
from custereomatching_tpu.ops import (
    stereo_matching_pallas_hdw,
    stereo_pipeline_trainable as jax_pipeline_trainable,
)
from custereomatching_tpu.ops.pallas_zncc_bwd import (
    pallas_camera_grad_banded,
    pallas_camera_grad_banded_hdw,
)
from custereomatching_tpu_torch.ops import (
    camera_grad_banded_cuda,
    camera_grad_banded_parity_cuda,
    extract_disparity_hdw,
    stereo_matching_hdw,
)
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    K5_MAX_KERNEL_SIZE,
    _check_k5_kernel_size,
    fused_pipeline_bwd_cuda,
    fused_pipeline_bwd_reference,
    fused_pipeline_train_cuda,
    fused_pipeline_train_reference,
    stereo_pipeline_cuda,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
    unnormalized_head,
)
from custereomatching_tpu_torch.ops.zncc import camera_grad_banded

# The JAX suite's gradient tolerance (tests/test_pallas_bwd.py:89) and its
# forward tolerance (tests/test_pallas_zncc.py:47).
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


def _cotangent(seed, H, W, D):
    """A ``[H, W, D+1]`` cotangent at a mean loss's scale (1 / (H W)), the
    regime in which atol 1e-6 sits above fp32 rounding."""
    g = np.random.default_rng(seed).standard_normal((H, W, D + 1))
    return (g / (H * W)).astype(np.float32)


@pytest.mark.parametrize("shape", [
    (24, 150, 10, 5, 8, 8),      # tests/test_pallas_bwd.py:37-50
    (16, 100, 37, 7, 16, 16),
])
def test_k6_parity_entry_matches_jax(shape):
    """K6's restaged entry (parity cotangent, no forward volume) against
    ``pallas_camera_grad_banded`` in interpret mode."""
    H, W, D, K, hb, dtb = shape
    cam, proj = _pair(0, H, W)
    g = _cotangent(1, H, W, D)
    want = np.asarray(pallas_camera_grad_banded(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), D, K, 1e-8, hb,
        dtb, True))
    calls = camera_grad_banded.calls
    got = camera_grad_banded_parity_cuda(
        torch.from_numpy(cam)[None], torch.from_numpy(proj)[None],
        torch.from_numpy(g)[None], D, K)
    assert camera_grad_banded.calls == calls + 1   # the plain closed form
    np.testing.assert_allclose(got[0].numpy(), want, **GRAD_TOL)


def test_k6_plane_major_entry_matches_jax():
    """K6's plane-major entry against ``pallas_camera_grad_banded_hdw``,
    the port's exact cotangent zero-padded into the JAX padded layout
    (tests/test_pallas_bwd.py:53-67)."""
    H, W, D, K, hb = 24, 150, 10, 5, 8
    cam, proj = _pair(1, H, W)
    g = _cotangent(2, H, W, D)
    wo, ndt = 256, 16
    h_pad = -(-H // hb) * hb
    gp = np.zeros((ndt, h_pad, wo), np.float32)
    gp[:D + 1, :H, :W] = np.transpose(g, (2, 0, 1))
    want = np.asarray(pallas_camera_grad_banded_hdw(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(gp), D, K, 1e-8, hb,
        8, True))
    launches = camera_grad_banded_cuda.recompute_launches
    got = camera_grad_banded_cuda(
        torch.from_numpy(cam)[None], torch.from_numpy(proj)[None], None,
        torch.from_numpy(np.ascontiguousarray(gp[None, :D + 1, :H, :W])), D,
        K)
    assert camera_grad_banded_cuda.recompute_launches == launches  # plain
    np.testing.assert_allclose(got[0].numpy(), want, **GRAD_TOL)


def test_k6_entries_check_their_cotangent():
    cam, proj = (torch.from_numpy(a)[None] for a in _pair(3, 8, 12))
    with pytest.raises(ValueError, match="plane-major volume"):
        camera_grad_banded_cuda(cam, proj, None, torch.zeros(1, 8, 12, 4), 3,
                                3)
    with pytest.raises(ValueError, match="parity volume"):
        camera_grad_banded_parity_cuda(cam, proj, torch.zeros(1, 4, 8, 12),
                                       3, 3)


# tests/test_pallas_bwd.py:358-387: H=56, W=200, D=24, k=11.  beta=50
# passes the unnormalized-head gate; beta=80 fails it (80 + ln(600) > 85).
@pytest.mark.parametrize("beta", [50.0, 80.0])
def test_volume_free_trainable_matches_jax(beta):
    H, W, D, K = 56, 200, 24, 11
    assert unnormalized_head(beta, D) == (beta == 50.0)
    cam, proj = _pair(11, H, W)
    target = np.random.default_rng(12).random((H, W), dtype=np.float32) * 5

    def jax_loss(c):
        r = jax_pipeline_trainable(c, jnp.asarray(proj), D, K, 1e-8, beta,
                                   0.6, True, save_volume=False)
        return (jnp.mean((r.soft_disparity - jnp.asarray(target)) ** 2)
                + 0.1 * jnp.mean(r.confidence)), r

    (v_want, maps_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(cam))

    cam_t = torch.from_numpy(cam)[None].requires_grad_(True)
    counts = (fused_pipeline_train_reference.calls,
              fused_pipeline_bwd_reference.calls)
    maps = stereo_pipeline_trainable(cam_t, torch.from_numpy(proj)[None], D,
                                     K, 1e-8, beta, 0.6, save_volume=False)
    loss = (torch.mean((maps.soft_disparity[0] - torch.from_numpy(target))
                       ** 2) + 0.1 * torch.mean(maps.confidence[0]))
    loss.backward()
    # The volume-free node ran its two plain twins, once each.
    assert (fused_pipeline_train_reference.calls,
            fused_pipeline_bwd_reference.calls) == (
                counts[0] + 1, counts[1] + 1)
    assert abs(float(loss.detach()) - float(v_want)) <= 1e-5 + 1e-4 * abs(
        float(v_want))
    for name in ("soft_disparity", "confidence"):
        np.testing.assert_allclose(getattr(maps, name)[0].detach().numpy(),
                                   np.asarray(getattr(maps_want, name)),
                                   **FWD_TOL)
    np.testing.assert_allclose(cam_t.grad[0].numpy(), np.asarray(g_want),
                               **GRAD_TOL)


@pytest.mark.parametrize("beta", [50.0, 80.0])
def test_volume_free_trainable_equals_save_volume(beta):
    """On the CPU both residual choices and the plain twin give the same
    maps and camera gradient: only what the kernels keep differs."""
    B, H, W, D, K = 2, 16, 40, 6, 5
    cam, proj = _pair(13, B, H, W)
    gen = np.random.default_rng(14)
    gs = torch.from_numpy(gen.standard_normal((B, H, W)).astype(np.float32))
    gc = torch.from_numpy(gen.standard_normal((B, H, W)).astype(np.float32))
    results = []
    for fn, save in ((stereo_pipeline_trainable, False),
                     (stereo_pipeline_trainable, True),
                     (stereo_pipeline_trainable_reference, False)):
        c = torch.from_numpy(cam).requires_grad_(True)
        out = fn(c, torch.from_numpy(proj), D, K, 1e-8, beta, 0.6,
                 save_volume=save)
        ((out.soft_disparity * gs).sum() + (out.confidence * gc).sum()
         ).backward()
        results.append((out, c.grad))
    (free, g_free), (saved, g_saved), (plain, g_plain) = results
    for name in free._fields:
        torch.testing.assert_close(getattr(free, name), getattr(saved, name),
                                   rtol=0, atol=0)
        torch.testing.assert_close(getattr(free, name), getattr(plain, name),
                                   **FWD_TOL)
    np.testing.assert_allclose(g_free.numpy(), g_saved.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(g_free.numpy(), g_plain.numpy(), **GRAD_TOL)


def test_volume_free_forward_has_no_volume():
    """K3m's plain twin: the four serving maps and the training maps of
    K3w's twin, and no volume."""
    cam, proj = (torch.from_numpy(a) for a in _pair(15, 1, 12, 30))
    maps, res = fused_pipeline_train_cuda(cam, proj, 5, 5, 1e-8, 50.0, 0.6,
                                          save_volume=False)
    serving = stereo_pipeline_cuda(cam, proj, 5, 5, 1e-8, 50.0, 0.6)
    _, res_v = fused_pipeline_train_cuda(cam, proj, 5, 5, 1e-8, 50.0, 0.6)
    assert res.volume is None and res_v.volume is not None
    for name in maps._fields:
        torch.testing.assert_close(getattr(maps, name),
                                   getattr(serving, name), **FWD_TOL)
    for a, b in zip(res[:5], res_v[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # Without a volume the backward's plain twin recomputes it (K5's
    # twin); with K3w's twin's volume it reads it (K4's): the same gradient.
    gs, gc = torch.ones(1, 12, 30) / 360, torch.ones(1, 12, 30) / 360
    calls = fused_pipeline_bwd_reference.calls
    a = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, 5, 5)
    b = fused_pipeline_bwd_cuda(cam, proj, res_v, gs, gc, 5, 5)
    assert fused_pipeline_bwd_reference.calls == calls + 2
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _k5_block_floats(k, chunk):
    """K5's planes block in floats (camera_grad.cuh: GradTile with the six
    head maps, then RecomputeTile over the halo'd tile) with the projector
    staged ``chunk`` planes at a time."""
    p = k // 2
    rows, cam_w = 16 + 2 * p, 64 + 2 * p
    halo = rows * cam_w
    grad_tile = 8 * halo + 16 * cam_w
    img_rows, x_w = 16 + 4 * p, 64 + 4 * p
    return grad_tile + img_rows * (2 * x_w + chunk - 1) + rows * x_w + halo


def test_k5_kernel_size_limit_follows_shared_memory():
    """The largest k whose K5 block fits an H100's 227 KB (58,112 floats)
    at one plane a projector staging, as the wrapper states; k = 15 at
    D = 192 needs no chunking (41,612 floats, the source note's count)."""
    limit = 227 * 1024 // 4
    assert _k5_block_floats(15, 193) == 41612
    assert _k5_block_floats(K5_MAX_KERNEL_SIZE, 1) <= limit
    assert _k5_block_floats(K5_MAX_KERNEL_SIZE + 2, 1) > limit
    _check_k5_kernel_size(K5_MAX_KERNEL_SIZE)
    with pytest.raises(ValueError, match=f"kernel_size <= {K5_MAX_KERNEL_SIZE}"):
        _check_k5_kernel_size(K5_MAX_KERNEL_SIZE + 2)


@pytest.mark.parametrize("grad_projector", [False, True])
def test_plane_major_op_matches_jax(grad_projector):
    """stereo_matching_hdw + extract_disparity_hdw against the JAX
    stereo_matching_pallas_hdw path (tests/test_pallas_bwd.py:70-89), the
    JAX padded volume cropped to the port's exact one."""
    H, W, D, K = 24, 150, 10, 5
    cam, proj = _pair(2, H, W)
    target = np.zeros((H, W), np.float32)

    def jax_loss(c, p):
        cv = stereo_matching_pallas_hdw(c, p, D, K, 1e-8, True,
                                        grad_projector)
        r = jax_head_hdw(cv, D, H, W)
        return jnp.mean((r.soft_disparity - jnp.asarray(target)) ** 2), cv

    argnums = (0, 1) if grad_projector else 0
    (_, cv_want), g_want = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(jnp.asarray(cam),
                                                 jnp.asarray(proj))
    g_want = g_want if grad_projector else (g_want,)

    cam_t = torch.from_numpy(cam).requires_grad_(True)
    proj_t = torch.from_numpy(proj).requires_grad_(grad_projector)
    cv = stereo_matching_hdw(cam_t, proj_t, D, K, 1e-8, grad_projector)
    assert cv.shape == (D + 1, H, W)
    np.testing.assert_allclose(cv.detach().numpy(),
                               np.asarray(cv_want)[:D + 1, :H, :W],
                               **FWD_TOL)
    r = extract_disparity_hdw(cv, D, H, W)
    torch.mean((r.soft_disparity - torch.from_numpy(target)) ** 2).backward()
    got = (cam_t.grad, proj_t.grad) if grad_projector else (cam_t.grad,)
    for a, b in zip(got, g_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    if not grad_projector:
        assert proj_t.grad is None


def test_plane_major_op_batched_is_the_parity_op_permuted():
    from custereomatching_tpu_torch.ops import stereo_matching
    cam, proj = (torch.from_numpy(a) for a in _pair(4, 2, 12, 20))
    hdw = stereo_matching_hdw(cam, proj, 4, 3)
    assert hdw.shape == (2, 5, 12, 20)
    torch.testing.assert_close(hdw, stereo_matching(cam, proj, 4, 3)
                               .permute(0, 3, 1, 2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="banded"):
        stereo_matching_hdw(cam, proj, None, 3)
