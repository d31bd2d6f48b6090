"""PyTorch port, the volume-free slice: the camera VJP without the cost
residual (K6, both entries), the volume-free trainable pipeline (K3m and
K5) and the plane-major volume op, held against the JAX package on the CPU
(its Pallas kernels in interpret mode), and the backward kernels at a k
past the limits they had before every odd k <= 127 ran.  CPU tensors take
the kernels' plain versions."""

from collections import Counter

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
from custereomatching_tpu.ops.pallas_pipeline import (
    PipelineMaps as JaxPipelineMaps,
)
from custereomatching_tpu.ops.pallas_zncc import pallas_cost_volume_banded_hdw
from custereomatching_tpu.ops.pallas_zncc_bwd import (
    pallas_camera_grad_banded,
    pallas_camera_grad_banded_hdw,
    pallas_projector_grad_banded_hdw_with_cost,
)
from custereomatching_tpu_torch.ops import (
    camera_grad_banded_cuda,
    camera_grad_banded_parity_cuda,
    extract_disparity_hdw,
    stereo_matching_hdw,
)
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    fused_pipeline_bwd_cuda,
    fused_pipeline_train_cuda,
    stereo_pipeline_cuda,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
    unnormalized_head,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.zncc import forward_banded
from custereomatching_tpu_torch.utils.kernel_model import (
    COST_CHUNK,
    cost_slab_planes,
    halo_fits,
    halo_round,
    halo_tile,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS

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
    before = COUNTS.copy()
    got = camera_grad_banded_parity_cuda(
        torch.from_numpy(cam)[None], torch.from_numpy(proj)[None],
        torch.from_numpy(g)[None], D, K)
    # The plain closed form.
    assert COUNTS - before == Counter({"plain.camera_grad_banded": 1})
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
    before = COUNTS.copy()
    got = camera_grad_banded_cuda(
        torch.from_numpy(cam)[None], torch.from_numpy(proj)[None], None,
        torch.from_numpy(np.ascontiguousarray(gp[None, :D + 1, :H, :W])), D,
        K)
    assert COUNTS - before == Counter({"plain.camera_grad_banded": 1})
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
    before = COUNTS.copy()
    maps = stereo_pipeline_trainable(cam_t, torch.from_numpy(proj)[None], D,
                                     K, 1e-8, beta, 0.6, save_volume=False)
    loss = (torch.mean((maps.soft_disparity[0] - torch.from_numpy(target))
                       ** 2) + 0.1 * torch.mean(maps.confidence[0]))
    loss.backward()
    # The volume-free node ran its two plain twins, once each; the
    # backward's recomputes the volume.
    assert COUNTS - before == Counter({
        "plain.fused_pipeline_train_reference": 1,
        "plain.fused_pipeline_bwd_reference": 1,
        "plain.forward_banded": 2, "plain.camera_grad_banded": 1})
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
    before = COUNTS.copy()
    a = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, 5, 5)
    b = fused_pipeline_bwd_cuda(cam, proj, res_v, gs, gc, 5, 5)
    assert COUNTS - before == Counter({
        "plain.fused_pipeline_bwd_reference": 2, "plain.forward_banded": 1,
        "plain.camera_grad_banded": 2})
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _k5_block_floats(k, chunk, planes=1):
    """K5's block in floats (fused_pipeline_bwd.cu: the halo entries'
    eight constants, the image tiles with the projector staged ``chunk``
    planes at a time, and ``planes`` planes of the round's two buffers)."""
    return halo_tile(k, chunk, planes)["floats"]


def test_k5_kernel_size_limit_follows_shared_memory():
    """K5's halo kernel keeps every k whose block fits an H100's 227 KB
    (58,112 floats) at one plane a round and a projector staging, k <= 27
    (k = 15 at D = 192: rounds of 5 planes and chunks of 125, 58,072
    floats, the source note's count); from k = 29 (59,080 floats, and from
    k = 31 more halo entries than its threads own) K5 takes the chunked
    route, a slab of COST_CHUNK planes of K1's costs, at k = 29 and at
    k = 127 alike, and never the whole volume."""
    limit = 227 * 1024 // 4
    assert halo_round(15, 192) == (5, 125)
    assert _k5_block_floats(15, 125, 5) == 58072
    assert _k5_block_floats(27, 1) <= limit
    assert _k5_block_floats(29, 1) == 59080 > limit
    assert halo_tile(31, 1, 1)["halo"] > 4 * 1024
    for D in (0, 1, 192, 1800, 4000):
        for k in range(3, 29, 2):
            assert halo_fits(k, D) and cost_slab_planes("K5", k, D) == 0
        for k in (29, 31, 127):
            assert not halo_fits(k, D)
            assert cost_slab_planes("K5", k, D) == min(COST_CHUNK, D + 1)
            assert cost_slab_planes("K5", k, D) < D + 1 or D + 1 <= (
                COST_CHUNK)


def _jax_pipeline_grad(cam, proj, gs, gc, D, k, save_volume):
    """The JAX trainable pipeline's camera gradient (interpret mode) for
    soft-disparity and confidence cotangents gs, gc."""
    H, W = cam.shape
    _, vjp = jax.vjp(lambda c: jax_pipeline_trainable(
        c, jnp.asarray(proj), D, k, 1e-8, 50.0, 0.6, True,
        save_volume=save_volume), jnp.asarray(cam))
    zeros = jnp.zeros((H, W), jnp.float32)
    (want,) = vjp(JaxPipelineMaps(disparity=zeros,
                                  soft_disparity=jnp.asarray(gs),
                                  mask=zeros, confidence=jnp.asarray(gc)))
    return np.asarray(want)


# One k past each limit the backward kernels had before every odd k <= 127
# ran on the card: K5 27, K4 47, K6 81, K7 93.
@pytest.mark.parametrize("kernel, k", [("K5", 29), ("K4", 49), ("K6", 83),
                                       ("K7", 95)])
def test_gradients_past_the_old_k_limits_match_jax(kernel, k):
    """The port's gradient (the wrappers' plain versions on CPU tensors)
    against the JAX op in interpret mode, as the JAX suite runs it, at the
    gradient tolerance: K5 and K4 through the trainable pipeline without
    and with the saved volume, K6 through its parity entry, K7 on the same
    cost and cotangent."""
    H, W, D = 24, 100, 6
    cam, proj = _pair(21, H, W)
    cam_t, proj_t = torch.from_numpy(cam)[None], torch.from_numpy(proj)[None]
    rng = np.random.default_rng(22)
    if kernel in ("K5", "K4"):
        save_volume = kernel == "K4"
        gs, gc = (rng.standard_normal((H, W)).astype(np.float32) / (H * W)
                  for _ in range(2))
        want = _jax_pipeline_grad(cam, proj, gs, gc, D, k, save_volume)
        c = cam_t.clone().requires_grad_(True)
        maps = stereo_pipeline_trainable(c, proj_t, D, k, 1e-8, 50.0, 0.6,
                                         save_volume=save_volume)
        ((maps.soft_disparity[0] * torch.from_numpy(gs)).sum()
         + (maps.confidence[0] * torch.from_numpy(gc)).sum()).backward()
        got = c.grad[0].numpy()
    elif kernel == "K6":
        g = _cotangent(23, H, W, D)
        want = np.asarray(pallas_camera_grad_banded(
            jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), D, k, 1e-8,
            8, 8, True))
        got = camera_grad_banded_parity_cuda(
            cam_t, proj_t, torch.from_numpy(g)[None], D, k)[0].numpy()
    else:
        jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
        vol = pallas_cost_volume_banded_hdw(jcam, jproj, D, k, 1e-8, 8, 8,
                                            True, True)
        g = _cotangent(24, H, W, D)
        gp = np.zeros(vol.shape, np.float32)
        gp[:D + 1, :H, :W] = np.transpose(g, (2, 0, 1))
        want = np.asarray(pallas_projector_grad_banded_hdw_with_cost(
            jcam, jproj, vol, jnp.asarray(gp), D, k, 1e-8, 8, 8, True))
        cost = forward_banded(cam_t, proj_t, D, k).permute(0, 3, 1, 2)
        got = projector_grad_banded_cuda(
            cam_t, proj_t, cost,
            torch.from_numpy(np.ascontiguousarray(gp[None, :D + 1, :H, :W])),
            D, k)[0].numpy()
    np.testing.assert_allclose(got, want, **GRAD_TOL)


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


# The keep-or-drop rule of the trainable fused pipeline: K3w + K4 keep the
# cost volume as the backward's residual where it takes at most 3/4 of the
# card's memory, else K3m + K5 run without it.
CARD = 80 * 10 ** 9        # an 80 GB card


@pytest.mark.parametrize("shape,capacity,keeps", [
    ((4, 375, 1242, 192), CARD, True),       # KITTI, 1.44 GB
    ((15, 1988, 2880, 289), CARD, False),    # MiddEval3 F, 99.6 GB
    ((1, 1988, 2880, 289), CARD, True),      # one frame, 6.6 GB
    ((1, 3, 4, 2), 192, True),                     # 144 B = 3/4 of 192
    ((1, 3, 4, 2), 191, False),
], ids=["kitti_b4", "middlebury_b15", "middlebury_b1", "at_bound",
        "past_bound"])
def test_keeps_volume_at_given_capacities(shape, capacity, keeps):
    from custereomatching_tpu_torch.models.stereo import keeps_volume

    assert keeps_volume(*shape, capacity) is keeps


def _routed(monkeypatch, capacity):
    """A matcher on the ``cuda`` backend over CPU tensors (the kernels'
    plain twins run), the card's memory ``capacity``, and the
    ``save_volume`` of each ``stereo_pipeline_trainable`` call."""
    from custereomatching_tpu_torch.config import StereoConfig
    from custereomatching_tpu_torch.models import stereo

    monkeypatch.setattr(stereo, "card_memory", lambda index: capacity)
    monkeypatch.setattr(StereoConfig, "resolved_backend",
                        lambda self, device: "cuda")
    saved = []

    def trainable(*args, save_volume=True, **kwargs):
        saved.append(save_volume)
        return stereo_pipeline_trainable(*args, save_volume=save_volume,
                                         **kwargs)

    monkeypatch.setattr(stereo, "stereo_pipeline_trainable", trainable)
    return stereo.StereoMatcher(StereoConfig(num_disparities=8,
                                             kernel_size=5)), saved


# [2, 20, 48] over 9 planes: a volume of 69,120 bytes, kept up to a card
# of 92,160.
@pytest.mark.parametrize("capacity,keeps", [
    (10 ** 9, True), (92_160, True), (92_159, False), (1, False)])
def test_trainable_maps_drop_the_volume_where_the_rule_says(monkeypatch,
                                                           capacity, keeps):
    model, saved = _routed(monkeypatch, capacity)
    cam, proj = (torch.from_numpy(a) for a in _pair(21, 2, 20, 48))
    before = COUNTS.copy()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.trainable_disparity_maps(cam, proj)
    assert saved == [keeps]
    assert COUNTS - before == Counter({
        "plain.fused_pipeline_train_reference": 1,
        "plain.forward_banded": 1,
        **({} if keeps else {"train.volume_free": 1})})
    spans = {e.name for e in prof.events()}
    assert ("custereo.model.volume_free" in spans) is not keeps


@pytest.mark.parametrize("capacity", [10 ** 9, 1], ids=["keep", "drop"])
def test_both_routes_match_jax_volume_free(monkeypatch, capacity):
    """The maps and the camera gradient of a mean-squared loss are the JAX
    volume-free pipeline's (``save_volume=False``, interpret mode) along
    either route."""
    B, H, W, D, K = 2, 20, 48, 8, 5
    model, saved = _routed(monkeypatch, capacity)
    cam, proj = _pair(22, B, H, W)
    target = np.random.default_rng(23).random((B, H, W),
                                              dtype=np.float32) * 6

    def jax_loss(c):
        maps = [jax_pipeline_trainable(c[b], jnp.asarray(proj[b]), D, K,
                                       1e-8, 50.0, 0.6, True,
                                       save_volume=False) for b in range(B)]
        soft = jnp.stack([m.soft_disparity for m in maps])
        conf = jnp.stack([m.confidence for m in maps])
        return jnp.mean((soft - jnp.asarray(target)) ** 2), (soft, conf)

    (_, (soft_want, conf_want)), g_want = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(cam))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    maps = model.trainable_disparity_maps(cam_t, torch.from_numpy(proj))
    torch.mean((maps.soft_disparity - torch.from_numpy(target)) ** 2
               ).backward()
    assert saved == [capacity > 1]
    np.testing.assert_allclose(maps.soft_disparity.detach().numpy(),
                               np.asarray(soft_want), **FWD_TOL)
    np.testing.assert_allclose(maps.confidence.detach().numpy(),
                               np.asarray(conf_want), **FWD_TOL)
    np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(g_want),
                               **GRAD_TOL)
