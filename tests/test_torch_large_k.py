"""PyTorch port: the kernels past their blocks' limits (the large-k route
of ``ops/cuda_large_k.py``) and K8 at k = 1, held against the JAX package
on the CPU.

The route's kernels (``csrc/large_k.cu``) run only on the card; here its
chains run step for step on their plain forms, and the wrappers' plain
versions run against the JAX kernels in interpret mode at k = 129 and 131
(K8 at 145 against the JAX XLA op: its Pallas kernel takes about a minute
in interpret mode at that k).  ``kernel_model``'s mirrored route choice
gives every odd k a route whose blocks fit the card."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import pallas_pipeline as jax_pipeline
from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_allpairs import (
    stereo_matching_pallas_allpairs,
)
from custereomatching_tpu.ops.pallas_zncc import (
    pallas_cost_volume_banded,
    pallas_cost_volume_banded_hdw,
)
from custereomatching_tpu.ops.pallas_zncc_bwd import (
    pallas_camera_grad_banded,
    pallas_projector_grad_banded_hdw_with_cost,
)
from custereomatching_tpu_torch import StereoConfig, StereoMatcher
from custereomatching_tpu_torch.ops import cuda_large_k as lk
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    fused_pipeline_train_reference,
    head_cotangent,
    head_residuals,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    unnormalized_head,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    camera_grad_banded_cuda,
    camera_grad_banded_parity_cuda,
    check_projector_kernel_size,
    cost_volume_banded_cuda,
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.zncc import (
    camera_grad_banded,
    forward_allpairs,
    forward_banded,
    projector_grad_banded,
)
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils.profiling import COUNTS

LIMIT = km.SMEM_OPTIN_BYTES // 4
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
EPS = 1e-8


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_blocks_fit(kernel, k, D, limit):
    """``kernel``'s own blocks at (k, D) within ``limit`` floats."""
    budget = dict(budget=limit)
    assert km.stats_block_floats(k) <= limit
    if kernel == "K8":
        assert km.allpairs_block_floats(k) <= limit
    elif kernel in ("K1", "K3", "K3w", "K3m"):
        assert km.fused_round(k, D, **budget)[0] >= 1
        assert km.fused_block_floats(k, D, **budget) <= limit
    else:
        assert km.combine_block_floats(k) <= limit
        if kernel == "K4":
            staged = km.k4_staged(k, D, **budget)
            planes, chunk = km.grad_round(k, D, True, False, staged,
                                          **budget)
            assert km.grad_round_tile(
                k, chunk, planes, head=True, recompute=False,
                staged=staged)["floats"] <= limit


@pytest.mark.parametrize("k", list(range(3, 257, 2)))
def test_route_choice_gives_every_k_a_fitting_route(k):
    """Every odd k from 3 to 255 at D = 0, 192 and 4000: each kernel's own
    blocks fit 227 KB (the statistics tile, K8's strip, a plane of
    ``fused_round`` or ``grad_round``, K5's halo kernel or its slabs), or
    it takes the large-k route, whose kernels hold nothing in shared
    memory.  k <= 127 keeps today's routes for every kernel; the route
    takes K1-K3, K5-K7 from k = 129, K8 from k = 145 and K4 (whose rounds
    read their constants from their maps past k = 47) from k = 187, where
    the statistics tile stops fitting."""
    for D in (0, 192, 4000):
        for kernel in km.LARGE_K_KERNELS:
            large = km.large_k_route(kernel, k, D)
            assert large == km.large_k_route(kernel, k, D, LIMIT)
            if k <= 127:
                assert not large, (kernel, k, D)
            first = {"K8": 145, "K4": 187}.get(kernel, 129)
            assert large == (k >= first), (kernel, k, D)
            if not large:
                _assert_blocks_fit(kernel, k, D, LIMIT)
    assert km.stats_block_floats(185) <= LIMIT < km.stats_block_floats(187)


# Opt-in budgets of other cards, in floats: 99 KB (sm_86, sm_89) and
# 163 KB (sm_80).
OTHER_BUDGETS = (101376 // 4, 166912 // 4)


@pytest.mark.parametrize("limit", OTHER_BUDGETS)
def test_route_choice_follows_the_budget(limit):
    """At a smaller opt-in budget each kernel takes the route earlier,
    from one k on, and below it its own blocks fit that budget: the
    wrappers ask at their card's budget (``cuda_zncc.smem_floats``)."""
    for D in (0, 192):
        for kernel in km.LARGE_K_KERNELS:
            route = [km.large_k_route(kernel, k, D, limit)
                     for k in range(3, 257, 2)]
            first = route.index(True)
            assert all(route[first:]) and not any(route[:first])
            assert 2 * first + 3 <= (145 if kernel == "K8" else 187)
            for k in range(3, 2 * first + 3, 2):
                _assert_blocks_fit(kernel, k, D, limit)


def test_smem_floats_reads_the_cards_budget(monkeypatch):
    """``smem_floats`` is the device's ``shared_memory_per_block_optin``
    in floats, the attribute the launchers read."""
    from custereomatching_tpu_torch.ops import cuda_zncc

    class Props:
        shared_memory_per_block_optin = 101376

    cuda_zncc._optin_floats.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props())
    try:
        assert cuda_zncc.smem_floats(torch.device("cuda", 1)) == 25344
    finally:
        cuda_zncc._optin_floats.cache_clear()


def test_k7_gate_matches_jax():
    """K7 takes k <= 129 and raises JAX's ``ValueError`` beyond, before any
    launch (``cuda_zncc.check_projector_kernel_size``)."""
    check_projector_kernel_size(129)
    with pytest.raises(ValueError, match="lane-aligned ext margin"):
        check_projector_kernel_size(131)
    cam, proj = _pair(0, 16, 40)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    vol = pallas_cost_volume_banded_hdw(jcam, jproj, 4, 131, EPS, 8, 8,
                                        True, True)
    with pytest.raises(ValueError, match="lane-aligned ext margin"):
        pallas_projector_grad_banded_hdw_with_cost(
            jcam, jproj, vol, jnp.zeros(vol.shape), 4, 131, EPS, 8, 8, True)


@pytest.mark.parametrize("k", [129, 131])
def test_k1_plain_and_route_match_pallas_interpret(k):
    """K1's plain version and the large-k route's chain on the CPU against
    JAX's ``_banded_kernel`` in interpret mode; the chain is the plain
    form's bit for bit."""
    H, W, D = 16, 40, 4
    cam, proj = _pair(k, H, W)
    want = np.asarray(pallas_cost_volume_banded(
        jnp.asarray(cam), jnp.asarray(proj), D, k, interpret=True))
    c, p = _t(cam[None], proj[None])
    plain = cost_volume_banded_cuda(c, p, D, k)[0]
    np.testing.assert_allclose(plain.numpy(), want, **FWD_TOL)
    route = lk.banded_volume_large(c, p, D, k, EPS).permute(0, 2, 3, 1)
    torch.testing.assert_close(route[0], plain, rtol=0, atol=0)


@pytest.mark.parametrize("k,beta", [(129, 50.0), (131, 50.0), (129, 83.0)])
def test_k3_plain_and_route_match_pallas_interpret(k, beta):
    """K3's plain version and the route's chain (K1's slabs, the head
    carried across them; both head branches: 83 + ln(20) > 85) against
    JAX's ``_fused_kernel`` in interpret mode, the JAX suite's head
    tolerances; the chain's maps equal the plain ones but for the soft
    disparity's last bits."""
    H, W, D = 16, 40, 4
    cam, proj = _pair(k + 1, H, W)
    want = jax_pipeline.pallas_stereo_pipeline(
        jnp.asarray(cam), jnp.asarray(proj), D, k, EPS, beta, 0.6, 8, 8,
        True)
    c, p = _t(cam[None], proj[None])
    plain = stereo_pipeline_cuda(c, p, D, k, EPS, beta, 0.6)
    maps, _ = lk.fused_pipeline_large(c, p, D, k, EPS, beta, 0.6,
                                      unnormalized_head(beta, D))
    for got in (plain, type(plain)(*maps[:4])):
        np.testing.assert_array_equal(got.disparity[0].numpy(),
                                      np.asarray(want.disparity))
        np.testing.assert_array_equal(got.mask[0].numpy(),
                                      np.asarray(want.mask))
        np.testing.assert_allclose(got.confidence[0].numpy(),
                                   np.asarray(want.confidence), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.soft_disparity[0].numpy(),
                                   np.asarray(want.soft_disparity),
                                   rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(maps[3], plain.confidence, rtol=0, atol=0)


@pytest.mark.parametrize("k", [129, 131])
def test_k6_and_k2_plain_and_route_match_pallas_interpret(k):
    """The camera VJP at large k: K6's plain version (the parity entry)
    against JAX's ``_bwd_kernel`` in its no-cost mode (interpret), and the
    route's chain with the cost recomputed (K6) and read (K2) against
    it, at the gradient tolerance with a mean loss's cotangent."""
    H, W, D = 16, 40, 4
    cam, proj = _pair(k + 2, H, W)
    g = (np.random.default_rng(k).standard_normal((H, W, D + 1))
         / (H * W)).astype(np.float32)
    want = np.asarray(pallas_camera_grad_banded(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), D, k, EPS, 8,
        8, True))
    c, p, gt = _t(cam[None], proj[None], g[None])
    plain = camera_grad_banded_parity_cuda(c, p, gt, D, k)[0]
    np.testing.assert_allclose(plain.numpy(), want, **GRAD_TOL)
    g_pm = gt.permute(0, 3, 1, 2).contiguous()
    vol = forward_banded(c, p, D, k).permute(0, 3, 1, 2).contiguous()
    for cost in (None, vol):
        route = lk.camera_grad_large(c, p, cost, g_pm, D, k, EPS)[0]
        np.testing.assert_allclose(route.numpy(), want, **GRAD_TOL)
    k2 = camera_grad_banded_cuda(c, p, vol, g_pm, D, k)[0]
    np.testing.assert_allclose(k2.numpy(), want, **GRAD_TOL)


def _jax_pipeline_grad(cam, proj, gs, gc, D, k, save_volume):
    H, W = cam.shape
    _, vjp = jax.vjp(lambda c: jax_pipeline.stereo_pipeline_trainable(
        c, jnp.asarray(proj), D, k, EPS, 50.0, 0.6, True,
        save_volume=save_volume), jnp.asarray(cam))
    zeros = jnp.zeros((H, W), jnp.float32)
    (want,) = vjp(jax_pipeline.PipelineMaps(
        disparity=zeros, soft_disparity=jnp.asarray(gs), mask=zeros,
        confidence=jnp.asarray(gc)))
    return np.asarray(want)


@pytest.mark.parametrize("save_volume", [True, False])
def test_k4_and_k5_plain_and_route_match_jax_at_k129(save_volume):
    """The trainable pipeline at k = 129: the port's plain node (K3w + K4,
    or K3m + K5, on CPU tensors) against JAX's trainable pipeline in
    interpret mode, and the route's chains (K3w's or K3m's head maps, then
    the VJP with the head cotangent formed per plane from the saved volume
    or from K1's recomputed slabs) against it."""
    H, W, D, k = 16, 40, 4, 129
    cam, proj = _pair(5, H, W)
    rng = np.random.default_rng(6)
    gs, gc = (rng.standard_normal((H, W)).astype(np.float32) / (H * W)
              for _ in range(2))
    want = _jax_pipeline_grad(cam, proj, gs, gc, D, k, save_volume)
    c, p = _t(cam[None], proj[None])
    x = c.clone().requires_grad_(True)
    maps = stereo_pipeline_trainable(x, p, D, k, EPS, 50.0, 0.6,
                                     save_volume=save_volume)
    gs_t, gc_t = _t(gs[None], gc[None])
    ((maps.soft_disparity * gs_t).sum()
     + (maps.confidence * gc_t).sum()).backward()
    np.testing.assert_allclose(x.grad[0].numpy(), want, **GRAD_TOL)

    un = unnormalized_head(50.0, D)
    out, vol = lk.fused_pipeline_large(c, p, D, k, EPS, 50.0, 0.6, un,
                                       residuals=True, volume=save_volume)
    _, _, mask, conf, am, s, t = out
    head = (am, mask, conf, s, t, gs_t, gc_t, 50.0, un)
    route = lk.camera_grad_large(c, p, vol, None, D, k, EPS, head=head)
    np.testing.assert_allclose(route[0].numpy(), want, **GRAD_TOL)


def test_k7_plain_and_route_match_pallas_interpret_at_k129():
    """K7 at k = 129, the largest k JAX's projector kernel takes: its plain
    closed form and the route's chain (fields in projector columns on the
    columns widened by p) against the kernel in interpret mode on the same
    cost and cotangent."""
    H, W, D, k = 16, 40, 4, 129
    cam, proj = _pair(7, H, W)
    g = (np.random.default_rng(8).standard_normal((D + 1, H, W))
         / (H * W)).astype(np.float32)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    vol = pallas_cost_volume_banded_hdw(jcam, jproj, D, k, EPS, 8, 8, True,
                                        True)
    gp = np.zeros(vol.shape, np.float32)
    gp[:D + 1, :H, :W] = g
    want = np.asarray(pallas_projector_grad_banded_hdw_with_cost(
        jcam, jproj, vol, jnp.asarray(gp), D, k, EPS, 8, 8, True))
    c, p, gt = _t(cam[None], proj[None], g[None])
    cost = forward_banded(c, p, D, k).permute(0, 3, 1, 2).contiguous()
    plain = projector_grad_banded_cuda(c, p, cost, gt, D, k)[0]
    np.testing.assert_allclose(plain.numpy(), want, **GRAD_TOL)
    route = lk.projector_grad_large(c, p, cost, gt, D, k, EPS)[0]
    np.testing.assert_allclose(route.numpy(), want, **GRAD_TOL)


def test_k7_route_takes_planes_past_the_row():
    """K7's chain at k = 129 with D > W + k // 2, where a plane's projector
    columns reach past the image by more than its width: the plain form of
    its field steps against ``jax.grad`` of JAX's both-gradients op and the
    plain closed form, on the same cost and cotangent."""
    H, W, D, k = 4, 20, 100, 129
    cam, proj = _pair(15, H, W)
    g = (np.random.default_rng(16).standard_normal((H, W, D + 1))
         / (H * W)).astype(np.float32)
    jcam, jg = jnp.asarray(cam), jnp.asarray(g)
    want = jax.grad(lambda p: jnp.sum(jax_zncc.stereo_matching_with_proj_grad(
        jcam, p, D, k) * jg))(jnp.asarray(proj))
    c, p, gt = _t(cam[None], proj[None], g[None])
    cost = forward_banded(c, p, D, k)
    plain = projector_grad_banded(c, p, cost, gt, D, k)
    route = lk.projector_grad_large(c, p, cost.permute(0, 3, 1, 2), gt.permute(
        0, 3, 1, 2), D, k, EPS)
    np.testing.assert_allclose(route[0].numpy(), np.asarray(want),
                               **GRAD_TOL)
    torch.testing.assert_close(route, plain, **GRAD_TOL)


@pytest.mark.parametrize("k", [145, 147])
def test_k8_plain_and_route_match_jax_past_its_strip(k):
    """K8 past its strip (k >= 145): the plain version against the JAX XLA
    op, and the route's chain (row products, the row sums, the
    normalisation) the plain form's bit for bit."""
    H, W = 16, 40
    cam, proj = _pair(k, H, W)
    want = np.asarray(jax_zncc.stereo_matching(jnp.asarray(cam),
                                               jnp.asarray(proj), None, k))
    c, p = _t(cam[None], proj[None])
    plain = cost_volume_allpairs_cuda(c, p, k)
    np.testing.assert_allclose(plain[0].numpy(), want, **FWD_TOL)
    route, _ = lk.allpairs_volume_large(c, p, k, EPS)
    torch.testing.assert_close(route, plain, rtol=0, atol=0)


def test_k8_takes_k1_as_jax_does():
    """K8's wrapper takes k = 1 (JAX's ``_allpairs_kernel`` gate is odd
    k >= 1).  At k = 1 every window is one pixel: E2 = 0 and exy = 0, so
    every cost is eps / sqrt(eps), the value of the JAX XLA op
    (``tests/test_zncc_op.py::test_kernel_size_one``), which the plain
    version gives and so does the default all-pairs matcher, whose camera
    gradient is finite.  JAX's Pallas kernel in interpret mode returns
    that value plus the rounding of its uncentred products, which eps no
    longer hides (within 5e-4 of it on this pair); every cost stays under
    the 0.6 threshold, so its maps are the same: all masked."""
    H, W = 12, 20
    cam, proj = _pair(1, H, W)
    jcam, jproj = jnp.asarray(cam), jnp.asarray(proj)
    xla = np.asarray(jax_zncc.stereo_matching(jcam, jproj, None, 1))
    pallas = np.asarray(stereo_matching_pallas_allpairs(jcam, jproj, 1, EPS,
                                                        True))
    c, p = _t(cam[None], proj[None])
    got = cost_volume_allpairs_cuda(c, p, 1)
    np.testing.assert_allclose(got[0].numpy(), xla, **FWD_TOL)
    np.testing.assert_allclose(got[0].numpy(), EPS / np.sqrt(EPS),
                               rtol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), pallas, rtol=0, atol=5e-4)
    assert pallas.max() < 0.6
    torch.testing.assert_close(got, forward_allpairs(c, p, 1), rtol=0,
                               atol=0)
    model = StereoMatcher(StereoConfig(kernel_size=1))
    x = c.clone().requires_grad_(True)
    out = model(x, p)
    np.testing.assert_allclose(out.cost_volume[0].detach().numpy(), xla,
                               **FWD_TOL)
    assert not bool(out.mask.any())
    out.soft_disparity.mean().backward()
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("k", [129, 131])
def test_route_chains_match_plain_versions(k):
    """Every chain of the route on the CPU against the wrappers' plain
    versions at a batch of two, D spanning two slabs and a short last one
    (D + 1 = 11): K1 bit for bit; K3, K3w, K3m's maps (both head branches)
    and am, s, t; the VJPs of K2, K6, K4, K5 and K7 at the gradient
    tolerance."""
    B, H, W, D = 2, 14, 36, 10
    cam, proj = _t(*_pair(k + 3, B, H, W))
    want = forward_banded(cam, proj, D, k)
    vol = lk.banded_volume_large(cam, proj, D, k, EPS)
    torch.testing.assert_close(vol.permute(0, 2, 3, 1), want, rtol=0,
                               atol=0)
    for beta in (50.0, 90.0):
        un = unnormalized_head(beta, D)
        maps, v = lk.fused_pipeline_large(cam, proj, D, k, EPS, beta, 0.6,
                                          un, residuals=True, volume=True)
        ref, res = fused_pipeline_train_reference(cam, proj, D, k, EPS,
                                                  beta, 0.6)
        torch.testing.assert_close(v, res.volume, rtol=0, atol=0)
        for i, name in enumerate(ref._fields):
            tol = dict(rtol=1e-5, atol=1e-6) if name == "soft_disparity" \
                else dict(rtol=0, atol=0)
            torch.testing.assert_close(maps[i], getattr(ref, name), **tol)
        torch.testing.assert_close(maps[4], res.am, rtol=0, atol=0)
        torch.testing.assert_close(maps[5], res.s, rtol=1e-5, atol=0)
        torch.testing.assert_close(maps[6], res.t, rtol=1e-5, atol=1e-30)
    rng = np.random.default_rng(k)
    g = torch.from_numpy((rng.standard_normal((B, D + 1, H, W))
                          / (H * W)).astype(np.float32))
    want_g = camera_grad_banded(cam, proj, g.permute(0, 2, 3, 1), D, k)
    for cost in (vol, None):
        torch.testing.assert_close(
            lk.camera_grad_large(cam, proj, cost, g, D, k, EPS), want_g,
            **GRAD_TOL)
    gs, gc = (torch.from_numpy(rng.standard_normal((B, H, W)).astype(
        np.float32) / (H * W)) for _ in range(2))
    am, conf, s, t = head_residuals(want, D, 50.0)
    mask = (conf > 0.6).to(conf.dtype)
    un = unnormalized_head(50.0, D)
    gh = head_cotangent(want, am, mask, conf, s, t, gs, gc, 50.0, un)
    want_h = camera_grad_banded(cam, proj, gh, D, k)
    head = (am, mask, conf, s, t, gs, gc, 50.0, un)
    for cost in (vol, None):
        torch.testing.assert_close(
            lk.camera_grad_large(cam, proj, cost, None, D, k, EPS,
                                 head=head), want_h, **GRAD_TOL)
    want_p = projector_grad_banded(cam, proj, want, g.permute(0, 2, 3, 1),
                                   D, k)
    torch.testing.assert_close(
        lk.projector_grad_large(cam, proj, vol, g, D, k, EPS), want_p,
        **GRAD_TOL)


def test_route_steps_count_only_card_launches():
    """On CPU tensors the route's steps run their plain forms and count no
    launch (no ``large_k.<step>``); the route functions count their calls,
    ``route.<K>`` for the kernel each stands in for."""
    cam, proj = _t(*_pair(3, 1, 10, 30))
    before = COUNTS.copy()
    lk.fused_pipeline_large(cam, proj, 3, 129, EPS, 50.0, 0.6, True,
                            residuals=True)
    assert COUNTS - before == Counter({"route.K3m": 1})
    before = COUNTS.copy()
    lk.camera_grad_large(cam, proj, None, None, 3, 129, EPS,
                         head=(*(torch.ones_like(cam),) * 7, 50.0, True))
    assert COUNTS - before == Counter({"route.K5": 1})


def test_large_k_cost_counts_the_route():
    """The route's counted work at KITTI, k = 129: every kernel has a
    finite positive model, K3 counts K1's planes and its head, K6 K1's
    planes and K2's fields, K5 K4's, and K8 its row products and row
    sums."""
    H, W, D, k = 375, 1242, 192, 129
    costs = {n: km.large_k_cost(n, H, W, D, k) for n in km.LARGE_K_KERNELS}
    for name, c in costs.items():
        assert c["smem"] > 0 and c.bytes > 0, name
    assert costs["K3"]["exp"] > 0 == costs["K1"]["exp"]
    assert costs["K6"]["smem"] > costs["K2"]["smem"]
    assert costs["K5"]["smem"] > costs["K4"]["smem"]
    assert costs["K4"]["exp"] > 0 == costs["K2"]["exp"]
    # K8's window sums on the FMA pipe: 2 k rounded products and adds an
    # output of the row products, k adds of the rows box (tile padding
    # included, so at least the outputs' count).
    ap = km.large_k_cost("K8", 330, 422, 0, 145)
    assert ap["madd"] >= 330 * 422 * 422 * 3 * 145


def test_route_scratch_holds_no_volume():
    """The route's slab scratch (``kernel_model.large_k_scratch``, which
    sizes ``_Slabs``): at KITTI K3, K3m, K5 and K6 hold three slabs of 8
    planes and never a whole volume, K7's fields live on the columns
    widened by p, and a short D takes D + 1 planes a slab."""
    H, W, D, k = 375, 1242, 192, 129
    volume = (D + 1) * H * W
    for name in ("K3", "K3m", "K5", "K6"):
        s = km.large_k_scratch(name, H, W, D, k)
        assert s == {"planes": 8, "width": W, "buffers": 3,
                     "floats": 3 * 8 * H * W}
        assert s["floats"] < volume / 8
    assert km.large_k_scratch("K7", H, W, D, k)["width"] == W + 64
    assert km.large_k_scratch("K2", 10, 30, 3, k)["floats"] == 2 * 4 * 300
    assert km.large_k_scratch("K8", H, W, 0, 145)["floats"] == 0
    with pytest.raises(ValueError, match="no large-k route"):
        km.large_k_scratch("K9a", H, W, D, k)
