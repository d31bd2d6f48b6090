"""PyTorch port: the pyramid matcher (``models/pyramid.py``) held against
the benchmark's plain float64 reference of the same algorithm
(``stereobench/reference/pyramid.py``) on the CPU.

The port runs on the torch backend; its levels are read through its own
methods, so each level is held to the reference on the port's own shift:
the fine level and the composition within the forward tolerances (rtol
1e-4 / atol 1e-5), the shift equal to the reference's own but where the
reference's ``f d_coarse`` lies within 1e-4 of a rounding boundary."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from custereomatching_tpu_torch import StereoConfig
from custereomatching_tpu_torch.models import PyramidStereoMatcher
from custereomatching_tpu_torch.models.pyramid import _avg_pool
from stereobench.reference import pyramid as ref
from stereobench.reference import zncc
from stereobench.traffic import generator

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
FORWARD = dict(rtol=1e-4, atol=1e-5)
# Where a last-bit difference may move a rounding, a hard disparity or a
# mask: a value within TIE of a half-integer, top two costs or the
# confidence and the threshold within TIE.
TIE = 1e-4
SCENE = {"dot_density": 0.08, "dot_sigma": 0.8, "noise": 0.01}

# name: (B, H, W, D, k, f, r, [(d_left, d_right) a frame])
CASES = {
    "w_not_a_multiple_of_f": (1, 26, 61, 20, 5, 4, 3, [(4.0, 16.0)]),
    "shift_clamps_at_minus_r_and_D": (1, 24, 64, 13, 5, 4, 2,
                                      [(0.0, 17.0)]),
    "two_frames": (2, 20, 48, 16, 7, 2, 4, [(3.0, 12.0), (13.0, 5.0)]),
}


def _pair(seed, H, W, planes):
    """Speckle frames, each a slanted plane from ``d_left`` to
    ``d_right``."""
    gen = generator.generator(seed, torch.device("cpu"))
    proj = generator.speckle(gen, len(planes), H, W,
                             dot_density=SCENE["dot_density"],
                             dot_sigma=SCENE["dot_sigma"])
    ramp = torch.linspace(0.0, 1.0, W)
    disp = torch.stack([(a + (b - a) * ramp).expand(H, W)
                        for a, b in planes])
    cam = generator.render(proj, disp)
    cam = cam + SCENE["noise"] * torch.randn(cam.shape, generator=gen)
    return cam.contiguous(), proj.contiguous()


def _config(D, k, f, r):
    return {"num_disparities": D, "kernel_size": k, "downsample": f,
            "residual": r, "softargmax_beta": 50.0, "cost_threshold": 0.6,
            "epsilon": 1e-8}


def _port_levels(pyr, cam, proj):
    """The port's call, level by level through its own methods."""
    coarse = pyr._coarse.disparity_maps(*pyr.coarse_pair(cam, proj))
    shift, proj_w = pyr.warp(proj, coarse.soft_disparity)
    fine = pyr._fine.disparity_maps(cam, proj_w)
    return shift, fine, pyr.compose(fine, shift)


def _half(x):
    return ((x - torch.floor(x)) - 0.5).abs() <= TIE


def _hold(got, want, skip):
    """A port's maps against the reference's (both ``[H, W]``): hard
    disparity and mask equal and confidence and soft disparity within the
    forward tolerances, but at ``skip``."""
    keep = ~skip
    assert torch.equal(got.mask.to(F64)[keep], want.mask[keep])
    assert torch.equal(got.disparity.to(F64)[keep], want.disparity[keep])
    torch.testing.assert_close(got.confidence.to(F64)[keep],
                               want.confidence[keep], **FORWARD)
    torch.testing.assert_close(got.soft_disparity.to(F64)[keep],
                               want.soft_disparity[keep], **FORWARD)


def _run(name):
    B, H, W, D, k, f, r, planes = CASES[name]
    cfg = _config(D, k, f, r)
    pyr = PyramidStereoMatcher(StereoConfig(num_disparities=D, kernel_size=k),
                               downsample=f, residual=r)
    cam, proj = _pair(sum(map(ord, name)), H, W, planes)
    with torch.no_grad():
        shift, fine, out = _port_levels(pyr, cam, proj)
        whole = pyr(cam, proj)
    for a, b in zip(out, whole):
        assert torch.equal(a, b)
    return cfg, cam, proj, shift, fine, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_port_is_the_reference_on_its_own_shift(name):
    cfg, cam, proj, shift, fine, out = _run(name)
    for b in range(cam.shape[0]):
        c, p, s = cam[b].to(F64), proj[b].to(F64), shift[b].to(F64)
        level, total = ref.fine(c, p, s, cfg)
        vol = zncc.volume(c, ref.warp(p, s), ref.fine_config(cfg))
        top2 = torch.topk(vol, 2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        tie = (gap <= TIE) | (
            (level.confidence - cfg["cost_threshold"]).abs() <= TIE)
        # Where the band lies out of view every plane reads one cost.
        flat = gap <= 1e-12
        frame = [m[b] for m in fine]
        _hold(type(fine)(*frame), level, tie)
        _hold(type(out)(*[m[b] for m in out]), total,
              tie | _half(level.soft_disparity))
        # The composition of the port's own fine level is the reference's.
        own = ref.compose(ref.Maps(*[m.to(F64) for m in frame]), s)
        _hold(type(out)(*[m[b] for m in out]), own,
              torch.zeros_like(tie))
        assert int((tie & ~flat).sum()) <= 0.01 * tie.numel()


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_shift_is_the_reference_own_outside_rounding_ties(name):
    cfg, cam, proj, shift, _, _ = _run(name)
    for b in range(cam.shape[0]):
        c = ref.coarse(cam[b].to(F64), proj[b].to(F64), cfg)
        differs = shift[b].to(F64) != c.shift
        assert not (differs & ~_half(c.d_up)).any()
        assert int(_half(c.d_up).sum()) <= 0.01 * c.d_up.numel()


def test_the_shift_clamps_at_both_ends():
    _, _, _, shift, _, _ = _run("shift_clamps_at_minus_r_and_D")
    _, _, _, D, _, _, r, _ = CASES["shift_clamps_at_minus_r_and_D"]
    assert float(shift.min()) == -r and float(shift.max()) == D


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_reference_coarse_level_is_zncc_on_its_pooled_pair(name):
    """The pooled pair of an independent edge-padded mean pool (and the
    port's), and on it the coarse level of ``reference/zncc.py`` over
    ceil(D / f) planes with an all-ones mask."""
    B, H, W, D, k, f, r, planes = CASES[name]
    cfg = _config(D, k, f, r)
    cam, proj = _pair(sum(map(ord, name)), H, W, planes)
    for b in range(B):
        c, p = cam[b].to(F64), proj[b].to(F64)
        pooled = []
        for img in (c, p):
            padded = F.pad(img[None, None], (0, (-W) % f, 0, (-H) % f),
                           mode="replicate")
            want = F.avg_pool2d(padded, f)[0, 0]
            torch.testing.assert_close(ref.pool(img, f), want, rtol=0,
                                       atol=1e-15)
            torch.testing.assert_close(
                _avg_pool(img.to(torch.float32), f).to(F64), want,
                rtol=1e-6, atol=1e-7)
            pooled.append(want)
        level = ref.coarse(c, p, cfg)
        cc = dict(cfg, num_disparities=-(-D // f), cost_threshold=-1.0)
        h = zncc.head(zncc.volume(*pooled, cc), cc)
        assert level.head.mask.all()
        torch.testing.assert_close(level.head.confidence, h.confidence,
                                   rtol=0, atol=1e-12)
        torch.testing.assert_close(level.head.soft, h.soft, rtol=0,
                                   atol=1e-12)
        up = h.soft.repeat_interleave(f, 0).repeat_interleave(f, 1)
        torch.testing.assert_close(level.d_up, f * up[:H, :W], rtol=0,
                                   atol=1e-12)


def test_the_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; import stereobench.reference.pyramid; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    loaded = set(proc.stdout.split())
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "custereomatching_tpu",
                         "custereomatching_tpu_torch"}
