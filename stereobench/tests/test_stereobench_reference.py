"""The benchmark's plain reference against the port's plain path, at tiny
shapes on the CPU, and the control (the reference in bfloat16) failing
every cell's comparison."""

import numpy as np
import pytest
import torch

from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.data import synthetic
from custereomatching_tpu_torch.models import optimize
from custereomatching_tpu_torch.models.stereo import StereoMatcher
from custereomatching_tpu_torch.ops import zncc as port_zncc
from custereomatching_tpu_torch.ops.disparity import extract_disparity
from stereobench import checks
from stereobench.reference import train as ref_train
from stereobench.reference import zncc
from stereobench.tests import tiny
from stereobench.tools import calibrate
from stereobench.traffic import generator

F64 = torch.float64


def pair(seed, B, H, W, d_max):
    sc = generator.scenes(seed, B, H, W, dict(tiny.SCENE, d_min=1.0,
                                               d_max=d_max), tiny.CPU)
    return sc.camera.to(F64), sc.projector.to(F64), sc.disparity.to(F64)


def config(D, k=5):
    return {"kernel_size": k, "num_disparities": D, "epsilon": 1e-8,
            "softargmax_beta": 50.0, "cost_threshold": 0.6}


@pytest.mark.parametrize("H,W,D,k", [(12, 30, 6, 5), (9, 17, 20, 3),
                                     (16, 24, 8, 7)])
def test_banded_volume_matches_the_port(H, W, D, k):
    cam, proj, _ = pair(3, 2, H, W, 5.0)
    port = port_zncc.forward_banded(cam, proj, D, k, 1e-8)
    for b in range(2):
        ours = zncc.banded_volume(cam[b], proj[b], D, k, 1e-8)
        torch.testing.assert_close(ours, port[b], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("H,W,k", [(10, 20, 5), (14, 9, 3), (12, 16, 7)])
def test_allpairs_volume_matches_the_port(H, W, k):
    cam, proj, _ = pair(4, 1, H, W, 3.0)
    port = port_zncc.forward_allpairs(cam, proj, k, 1e-8)
    ours = zncc.allpairs_volume(cam[0], proj[0], k, 1e-8)
    torch.testing.assert_close(ours, port[0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("D", [6, None])
def test_head_matches_the_port(D):
    cam, proj, _ = pair(5, 1, 14, 26, 4.0)
    cfg = config(D)
    vol = zncc.volume(cam[0], proj[0], cfg)
    h = zncc.head(vol, cfg)
    port = extract_disparity(vol, D, 0.6, 50.0)
    m = h.mask.to(F64)
    torch.testing.assert_close(m, port.mask)
    torch.testing.assert_close(h.confidence, port.confidence)
    torch.testing.assert_close(h.soft * m, port.soft_disparity)
    hard = zncc.disparity_of_index(h.index, cfg).to(F64) * m
    torch.testing.assert_close(hard, port.disparity)
    assert torch.equal(zncc.index_of_disparity(hard, cfg)[h.mask],
                       h.index[h.mask])


@pytest.mark.parametrize("D", [6, None])
def test_loss_and_gradient_match_the_port(D):
    cam, proj, disp = pair(6, 2, 12, 22, 4.0)
    cfg = config(D)
    model = StereoMatcher(StereoConfig(kernel_size=5, num_disparities=D))
    leaf = cam.clone().requires_grad_(True)
    loss = optimize.disparity_loss(model, leaf, proj, disp)
    loss.backward()
    ev = ref_train.evaluate(cam, proj, disp, cfg, F64)
    torch.testing.assert_close(ev.loss, loss.detach(), rtol=1e-10, atol=0)
    torch.testing.assert_close(ev.grad, leaf.grad, rtol=1e-8, atol=1e-14)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p = torch.randn(50, generator=g, dtype=F64)
    leaf = p.clone().requires_grad_(True)
    opt = optimize.adam(1e-2)([leaf])
    state = ref_train.adam_zero(p, F64)
    ours = p.clone()
    for _ in range(4):
        grad = torch.randn(50, generator=g, dtype=F64) * 1e-3
        leaf.grad = grad.clone()
        opt.step()
        change, state = ref_train.adam_update(state, grad, 1e-2)
        ours = ours + change
    torch.testing.assert_close(ours, leaf.detach(), rtol=1e-12, atol=1e-15)


def test_adam_gain_bounds_the_update_under_a_scaled_gradient():
    g = torch.Generator().manual_seed(1)
    for t in (1, 2, 3, 40):
        m = torch.randn(2000, generator=g, dtype=F64) * 1e-3
        v = torch.rand(2000, generator=g, dtype=F64) * 1e-6
        grad = torch.randn(2000, generator=g, dtype=F64) * 1e-3
        state = ref_train.AdamState(m=m, v=v, t=t - 1)
        u, _ = ref_train.adam_update(state, grad, 1.0)
        a = 1e-6
        u2, _ = ref_train.adam_update(state, grad * (1 + a), 1.0)
        bound = a * (ref_train.adam_gain(t) + u.abs())
        assert bool(((u2 - u).abs() <= bound * (1 + 1e-3) + 1e-15).all())


def test_generator_renders_as_the_port_does():
    gen = generator.generator(9, tiny.CPU)
    proj = generator.speckle(gen, 1, 20, 30, dot_density=0.1,
                             dot_sigma=0.8)[0]
    disp = torch.linspace(1.0, 7.5, 30).expand(20, 30)
    ours = generator.render(proj[None], disp[None])[0]
    port = synthetic.render_camera(proj.numpy(), disp.numpy())
    np.testing.assert_allclose(ours.numpy(), port, rtol=1e-6, atol=1e-7)


def test_generator_blurs_as_the_port_does():
    dots = (torch.rand((1, 18, 25), generator=torch.Generator().manual_seed(2))
            < 0.1).float()
    radius = 2
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    taps = torch.exp(-0.5 * (x / 0.8) ** 2)
    taps = taps / taps.sum()
    ours = generator._blur_axis(generator._blur_axis(dots, taps, 2), taps, 1)
    img = dots[0].numpy()
    g = taps.numpy()
    img = np.apply_along_axis(lambda r: np.convolve(r, g, mode="same"), 1,
                              img)
    img = np.apply_along_axis(lambda c: np.convolve(c, g, mode="same"), 0,
                              img)
    np.testing.assert_allclose(ours[0].numpy(), img, rtol=1e-5, atol=1e-6)


def test_generator_is_a_function_of_the_seed():
    scene = dict(tiny.SCENE, d_min=2.0, d_max=9.0)
    a = generator.scenes(2 ** 31 + 99, 2, 10, 20, scene, tiny.CPU)
    b = generator.scenes(2 ** 31 + 99, 2, 10, 20, scene, tiny.CPU)
    c = generator.scenes(2 ** 31 + 100, 2, 10, 20, scene, tiny.CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.projector, c.projector)


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_the_control_fails_the_cell(workload):
    found = calibrate.control(tiny.cell(workload), 2 ** 31 + 3, tiny.CPU)
    assert not checks.verdict(found), found


@pytest.mark.card
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_the_control_fails_the_cell_at_its_own_size(card, workload):
    from stereobench import harness

    cell = harness.resolve(tiny.manifest(), workload)
    found = calibrate.control(cell, 2 ** 31 + 5, card)
    assert not checks.verdict(found), found
