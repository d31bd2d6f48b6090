"""PyTorch port, the volume head: the plain twin of K8h / K8hb's one-pass
arithmetic (here: max, first argmax, tie count, s, t and the
closed-form cotangent with amax's tie split, in plain torch) held against
the plain head ``extract_disparity`` and its autograd on the CPU, the
autograd node of ``ops/cuda_head.py`` with the twin in its kernels'
place, the wrapper's refusals and the matcher's routing; on the card, K8h
and K8hb against the plain head.  ``test_torch_volume_head_jax.py`` holds
the twin against the JAX package's head.

The file imports no JAX, so on the card: ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_volume_head.py -q``.
"""

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import pytest
import torch

from custereomatching_tpu_torch import StereoConfig, StereoMatcher
from custereomatching_tpu_torch.models import stereo as stereo_model
from custereomatching_tpu_torch.ops import cuda_head
from custereomatching_tpu_torch.ops.cuda_head import (
    VolumeHead,
    extract_disparity_cuda,
)
from custereomatching_tpu_torch.ops.disparity import (
    DisparityResult,
    extract_disparity,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS

# The JAX suite's head tolerance (forward) and gradient tolerance
# (tests/test_pallas_bwd.py:89).
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
# In fp32 the softmax's VJP cancels at the winning entries (j - corr, or
# the plain form's j g - sum p j g), so any two orders of the sums differ
# there by rounding noise on the scale of the row's largest entry: up to
# 1.0e-6 of the gradient's largest entry beyond GRAD_TOL's rtol here (5
# seeds of every case), as tests/test_torch_disparity.py's hdw test finds
# ~1e-5 of a gradient reaching ~70.  fp32 comparisons add that noise, ten
# times over, to GRAD_TOL's atol; fp64 ones hold GRAD_TOL itself.
F32_GRAD_NOISE = 1e-5
# On the card the soft map keeps FWD_TOL's rtol and takes atol 1e-3 px:
# all-pairs it is w - corr, which cancels where corr is near w, so corr's
# rounding in the order of the sums (a few ulp of L: 1.5e-4 px at L =
# 422) shows as an absolute error, not a relative one.
CARD_SOFT_TOL = dict(rtol=FWD_TOL["rtol"], atol=1e-3)
THRESHOLD, BETA = 0.6, 50.0

# (batch or None for [H, W, L], H, W, num_disparities or None): L = W
# all-pairs, D + 1 banded; L off 32 and 4 (37, 45, 13), L < 32 (7, 13, 5),
# L a multiple of 4 (64, 8).
CASES = [
    (None, 5, 37, None),
    (1, 4, 37, None),
    (2, 3, 13, None),
    (1, 6, 64, None),
    (2, 2, 5, None),
    (None, 4, 11, 6),
    (1, 5, 9, 44),
    (2, 3, 10, 12),
    (1, 4, 8, 63),
    (2, 2, 6, 7),
]


def volume_head_reference(cost: torch.Tensor,
                          num_disparities: Optional[int] = None,
                          threshold: float = 0.6, beta: float = 50.0
                          ) -> Tuple[DisparityResult, torch.Tensor]:
    """K8h's arithmetic, the twin: the maps of ``extract_disparity`` and the
    residuals ``[3, ...]`` K8hb reads (s, corr and the count of entries
    tied at the maximum).

    ``m = max c``, the first argmax, ``e = exp(beta c - beta m)``, ``s =
    sum e``, ``t = sum j e`` and ``corr = t / s``."""
    dtype = cost.dtype
    conf = torch.amax(cost, dim=-1)
    arg = torch.argmax(cost, dim=-1).to(dtype)
    ties = (cost == conf[..., None]).sum(dim=-1).to(dtype)
    e = torch.exp(cost * beta - (conf * beta)[..., None])
    j = torch.arange(cost.shape[-1], dtype=dtype, device=cost.device)
    s = e.sum(dim=-1)
    corr = (e * j).sum(dim=-1) / s
    mask = (conf > threshold).to(dtype)
    if num_disparities is None:
        w = torch.arange(cost.shape[-2], dtype=dtype, device=cost.device)
        maps = DisparityResult((w - arg) * mask, (w - corr) * mask, mask,
                               conf)
    else:
        maps = DisparityResult(arg * mask, corr * mask, mask, conf)
    return maps, torch.stack((s, corr, ties))


def volume_head_vjp_reference(cost: torch.Tensor, conf: torch.Tensor,
                              resid: torch.Tensor,
                              g_soft: Optional[torch.Tensor],
                              g_conf: Optional[torch.Tensor],
                              all_pairs: bool, threshold: float = 0.6,
                              beta: float = 50.0) -> torch.Tensor:
    """K8hb's arithmetic: the cost cotangent that ``g_soft`` and
    ``g_conf`` (either None: no cotangent) induce,

        g_c[j] = beta g_corr / s * e[j] * (j - corr)
               + (c[j] == m) g_conf / ties,

    ``g_corr = -mask g_soft`` all-pairs and ``+mask g_soft`` banded: the
    softmax's and the sum's VJP in closed form, and amax's, which splits
    ``g_conf`` evenly over a tie as torch's and JAX's do."""
    s, corr, ties = resid.unbind(0)
    grad = torch.zeros_like(cost)
    if g_soft is not None:
        g = g_soft * (conf > threshold).to(cost.dtype)
        coef = beta * (-g if all_pairs else g) / s
        e = torch.exp(cost * beta - (conf * beta)[..., None])
        j = torch.arange(cost.shape[-1], dtype=cost.dtype,
                         device=cost.device)
        grad = coef[..., None] * e * (j - corr[..., None])
    if g_conf is not None:
        grad = grad + (cost == conf[..., None]).to(cost.dtype) * (
            g_conf / ties)[..., None]
    return grad


def _case_id(case):
    B, H, W, D = case
    mode = "allpairs" if D is None else f"D{D}"
    return f"B{B}-{H}x{W}-{mode}"


def _volume(case, seed=0):
    """A ZNCC-like volume in [-1, 1] with rows of exact ties (the maximum
    repeated at a later index), rows whose maximum is under the
    threshold, and one row whose maximum equals the threshold."""
    B, H, W, D = case
    L = W if D is None else D + 1
    shape = (H, W, L) if B is None else (B, H, W, L)
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    rows = c.reshape(-1, L)
    n = rows.shape[0]
    for r in range(0, n, 3):            # ties: the maximum, again later
        i, j = sorted(rng.choice(L, size=2, replace=False)) if L > 1 \
            else (0, 0)
        top = rows[r].max() + 0.05
        rows[r, i] = rows[r, j] = top
    for r in range(1, n, 4):            # under the threshold
        rows[r] = rows[r] * 0.5
    rows[2 % n] = np.minimum(rows[2 % n], np.float32(THRESHOLD))
    rows[2 % n, 0] = np.float32(THRESHOLD)
    return torch.from_numpy(c)


def _cotangents(maps, which, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = maps.confidence.shape
    g_soft = torch.randn(shape, generator=g) if which in ("soft", "both") \
        else None
    g_conf = torch.randn(shape, generator=g) if which in ("conf", "both") \
        else None
    return g_soft, g_conf


def _grad_tol(want):
    if want.dtype == torch.float64:
        return GRAD_TOL
    return dict(rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"]
                + F32_GRAD_NOISE * float(want.abs().max()))


def _plain_grad(cost, D, g_soft, g_conf):
    leaf = cost.clone().requires_grad_(True)
    r = extract_disparity(leaf, D, THRESHOLD, BETA)
    outs = [o for o, g in ((r.soft_disparity, g_soft),
                           (r.confidence, g_conf)) if g is not None]
    torch.autograd.backward(outs, [g for g in (g_soft, g_conf)
                                   if g is not None])
    return leaf.grad


def test_volumes_hold_ties_and_rows_under_the_threshold():
    for case in CASES:
        c = _volume(case)
        rows = c.reshape(-1, c.shape[-1])
        ties = (rows == rows.amax(-1, keepdim=True)).sum(-1)
        conf = rows.amax(-1)
        assert bool((ties > 1).any()) or rows.shape[-1] == 1, case
        assert bool((conf <= THRESHOLD).any()), case
        assert bool((conf > THRESHOLD).any()), case


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_twin_forward_matches_the_plain_head(case):
    """Hard map, mask and confidence bit for bit (max and first argmax
    are exact); the soft map within the head's tolerance."""
    c = _volume(case)
    D = case[3]
    want = extract_disparity(c, D, THRESHOLD, BETA)
    got, resid = volume_head_reference(c, D, THRESHOLD, BETA)
    for name in ("disparity", "mask", "confidence"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.soft_disparity, want.soft_disparity,
                               **FWD_TOL)
    assert resid.shape == (3,) + c.shape[:-1]
    s, corr, ties = resid
    rows = c.reshape(-1, c.shape[-1])
    assert torch.equal(ties.reshape(-1), (rows == rows.amax(
        -1, keepdim=True)).sum(-1).float())
    assert bool((s >= 1).all())
    assert bool(((corr >= 0) & (corr <= c.shape[-1] - 1)).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["fp64", "fp32"])
@pytest.mark.parametrize("which", ["soft", "conf", "both"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_twin_vjp_matches_the_plain_autograd(case, which, dtype):
    """The closed-form cotangent, with amax's even split over a tie,
    against autograd through the plain head: in fp64 the arithmetic, in
    fp32 its rounding."""
    c = _volume(case).to(dtype)
    D = case[3]
    maps, resid = volume_head_reference(c, D, THRESHOLD, BETA)
    g_soft, g_conf = (None if g is None else g.to(dtype)
                      for g in _cotangents(maps, which))
    got = volume_head_vjp_reference(c, maps.confidence, resid, g_soft,
                                    g_conf, D is None, THRESHOLD, BETA)
    want = _plain_grad(c, D, g_soft, g_conf)
    torch.testing.assert_close(got, want, **_grad_tol(want))
    if g_conf is not None:
        # The confidence's share lands only on the tied maxima, split.
        only_conf = volume_head_vjp_reference(
            c, maps.confidence, resid, None, g_conf, D is None, THRESHOLD,
            BETA)
        hit = c == maps.confidence[..., None]
        assert torch.equal(only_conf != 0, hit & (g_conf != 0)[..., None])
        torch.testing.assert_close(only_conf.sum(-1), g_conf)


@pytest.fixture
def twin_node(monkeypatch):
    """The node on CPU tensors: its two launches replaced by the twin, so
    the node's own work (checks, layout, residuals, cotangents) runs
    here.  Returns the layouts the launches were given, in order."""
    layouts = []

    def forward(cost, num_disparities, threshold, beta, plane_major):
        layouts.append(plane_major)
        return volume_head_reference(cost, num_disparities, threshold, beta)

    def vjp(cost, conf, resid, g_soft, g_conf, all_pairs, threshold, beta,
            plane_major):
        layouts.append(plane_major)
        return volume_head_vjp_reference(cost, conf, resid, g_soft, g_conf,
                                         all_pairs, threshold, beta)

    monkeypatch.setattr(cuda_head, "_head_forward", forward)
    monkeypatch.setattr(cuda_head, "_head_vjp", vjp)
    return layouts


@pytest.mark.parametrize("which", ["soft", "conf", "both"])
@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[7]],
                         ids=_case_id)
def test_node_on_cpu_matches_the_plain_autograd(case, which, twin_node):
    """The autograd node (the twin in its kernels' place): its maps as
    the plain head's, and the gradient of a loss on the outputs it
    uses."""
    c = _volume(case)
    D = case[3]
    leaf = c.clone().requires_grad_(True)
    out = VolumeHead.apply(leaf, D, THRESHOLD, BETA)
    want = extract_disparity(c, D, THRESHOLD, BETA)
    assert torch.equal(out[0], want.disparity)
    assert not out[0].requires_grad and not out[2].requires_grad
    g_soft, g_conf = _cotangents(want, which)
    outs = [o for o, g in ((out[1], g_soft), (out[3], g_conf))
            if g is not None]
    torch.autograd.backward(outs, [g for g in (g_soft, g_conf)
                                   if g is not None])
    want = _plain_grad(c, D, g_soft, g_conf)
    torch.testing.assert_close(leaf.grad, want, **_grad_tol(want))


def test_node_passes_no_cotangent_for_an_unused_output(monkeypatch,
                                                       twin_node):
    """An output the loss does not use reaches the VJP as None (no zeros
    materialised), and with neither used nothing runs."""
    seen = []

    def spy(cost, conf, resid, g_soft, g_conf, *args):
        seen.append((g_soft is None, g_conf is None))
        return torch.zeros_like(cost)

    monkeypatch.setattr(cuda_head, "_head_vjp", spy)
    c = _volume(CASES[1])
    leaf = c.clone().requires_grad_(True)
    out = VolumeHead.apply(leaf, None, THRESHOLD, BETA)
    out[1].sum().backward()
    out = VolumeHead.apply(leaf, None, THRESHOLD, BETA)
    out[3].sum().backward()
    assert seen == [(False, True), (True, False)]


def _plane_major_view(c):
    """The ``[..., H, W, L]`` view of a contiguous ``[..., L, H, W]`` copy
    of ``c``: K1's layout."""
    return c.movedim(-1, -3).contiguous().movedim(-3, -1)


def test_the_kernels_walk_two_layouts():
    c = _volume(CASES[7])
    D = CASES[7][3]
    assert cuda_head._check_volume(c, D, BETA) is False
    assert cuda_head._check_volume(_plane_major_view(c), D, BETA) is True
    assert cuda_head._check_volume(_plane_major_view(c[0]), D, BETA) is True
    with pytest.raises(ValueError, match="strided"):
        cuda_head._check_volume(c.transpose(-2, -3), D, BETA)


@pytest.mark.parametrize("case", [CASES[2], CASES[7]], ids=_case_id)
def test_node_takes_a_plane_major_view(case, twin_node):
    """K1's layout through the node: the plain head's maps and gradient,
    the layout read once forward and handed to the VJP."""
    c = _volume(case)
    D = case[3]
    leaf = _plane_major_view(c).requires_grad_(True)
    out = VolumeHead.apply(leaf, D, THRESHOLD, BETA)
    want = extract_disparity(c, D, THRESHOLD, BETA)
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w, **FWD_TOL)
    g_soft, _ = _cotangents(want, "soft")
    out[1].backward(g_soft)
    want_grad = _plain_grad(c, D, g_soft, None)
    torch.testing.assert_close(leaf.grad, want_grad, **_grad_tol(want_grad))
    assert twin_node == [True, True]


def test_cpu_tensor_takes_the_plain_head():
    c = _volume(CASES[1]).requires_grad_(True)
    before = COUNTS.copy()
    got = extract_disparity_cuda(c, None, THRESHOLD, BETA)
    want = extract_disparity(c, None, THRESHOLD, BETA)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.soft_disparity.grad_fn.name() == \
        want.soft_disparity.grad_fn.name()
    got.soft_disparity.sum().backward()
    assert COUNTS == before


@pytest.mark.parametrize("bad", [
    dict(dtype=torch.float64),
    dict(strided=True),
    dict(shape=(5, 7)),
    dict(shape=(1, 2, 3, 4, 5)),
    dict(shape=(2, 3, 0)),
    dict(num_disparities=5),
    dict(beta=0.0),
    dict(beta=-1.0),
    dict(strided=True, num_disparities=2),
])
def test_node_refuses_what_the_kernels_do_not_take(bad):
    shape = bad.get("shape", (2, 3, 7))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    if bad.get("strided"):
        x = torch.zeros((2, 7, 3)).transpose(1, 2)
    with pytest.raises(ValueError,
                       match="strided" if bad.get("strided") else None):
        VolumeHead.apply(x, bad.get("num_disparities"), THRESHOLD,
                         bad.get("beta", BETA))


def test_matcher_routes_the_cuda_backend_to_the_kernel_head(monkeypatch):
    """``StereoMatcher.disparity`` calls ``extract_disparity_cuda`` on the
    cuda backend and the plain head on torch."""
    calls = []

    def spy(*args):
        calls.append(args[1:])
        return extract_disparity(*args)

    monkeypatch.setattr(stereo_model, "extract_disparity_cuda", spy)
    c = _volume(CASES[7])
    torch_model = StereoMatcher(StereoConfig(kernel_size=3,
                                             num_disparities=12))
    want = torch_model.disparity(c)
    assert calls == []
    monkeypatch.setattr(StereoConfig, "resolved_backend",
                        lambda self, device: "cuda")
    got = torch_model.disparity(c)
    assert calls == [(12, 0.6, 50.0)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


def _card_check(card, cost, D, seed):
    """K8h's maps against the plain head (hard map, mask and confidence
    bit for bit), then K8hb's gradient against the plain autograd, on
    cotangents at a mean loss's scale; one launch of each."""
    before = COUNTS.copy()
    leaf = cost.clone().requires_grad_(True)
    got = extract_disparity_cuda(leaf, D, THRESHOLD, BETA)
    want = extract_disparity(cost, D, THRESHOLD, BETA)
    for name in ("disparity", "mask", "confidence"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.soft_disparity, want.soft_disparity,
                               **CARD_SOFT_TOL)
    g = torch.Generator(card).manual_seed(seed)
    n = got.confidence.numel()
    g_soft = torch.randn(got.confidence.shape, generator=g,
                         device=card) / n
    g_conf = torch.randn(got.confidence.shape, generator=g,
                         device=card) / n
    torch.autograd.backward([got.soft_disparity, got.confidence],
                            [g_soft, g_conf])
    want = _plain_grad(cost, D, g_soft, g_conf)
    torch.testing.assert_close(leaf.grad, want, **_grad_tol(want))
    assert COUNTS - before == Counter({"K8h": 1, "K8hb": 1})


@pytest.mark.card
def test_card_head_matches_the_plain_head_at_the_verify_shape(card):
    """330 x 422 all-pairs, on K8's volume of a random pair (rows 8-byte
    aligned: 8-byte loads) and on a volume with ties."""
    from custereomatching_tpu_torch.ops.cuda_allpairs import (
        cost_volume_allpairs_cuda,
    )

    g = torch.Generator(card).manual_seed(0)
    cam, proj = (torch.rand((1, 330, 422), generator=g, device=card)
                 for _ in range(2))
    _card_check(card, cost_volume_allpairs_cuda(cam, proj, 15), None, 1)
    _card_check(card, _volume((1, 330, 422, None)).to(card), None, 2)


@pytest.mark.card
@pytest.mark.parametrize("layout", ["parity", "plane_major"])
@pytest.mark.parametrize("shape", [
    (1, 6, 1242, 192),   # a KITTI-width banded row: L = 193, 4-byte loads
    (2, 5, 300, 63),     # L = 64: 16-byte loads
    (1, 4, 700, 599),    # L = 600: two row tiles (a rescale)
    (1, 3, 40, 2),       # L = 3
])
def test_card_head_matches_the_plain_head_banded(card, shape, layout):
    B, H, W, D = shape
    cost = _volume((B, H, W, D)).to(card)
    if layout == "plane_major":
        cost = _plane_major_view(cost)
    _card_check(card, cost, D, 3)


@pytest.mark.card
def test_card_cotangent_keeps_the_volume_layout(card):
    """K8hb writes the cotangent in the volume's layout: a plane-major
    volume's is plane-major, so K2 and K7 read it with no copy."""
    cost = _plane_major_view(_volume((2, 5, 40, 12)).to(card))
    assert cuda_head._check_volume(cost, 12, BETA) is True
    maps, resid = cuda_head._head_forward(cost, 12, THRESHOLD, BETA, True)
    g = torch.ones_like(maps.confidence)
    out = cuda_head._head_vjp(cost, maps.confidence, resid, g, None, False,
                              THRESHOLD, BETA, True)
    assert out.stride() == cost.stride()
    assert out.movedim(-1, -3).is_contiguous()


@pytest.mark.card
def test_card_banded_matcher_gradient(card):
    """The banded matcher on the card (K1, K8h, K8hb, K2): the camera
    gradient of a mean soft-disparity loss is the plain model's."""
    g = torch.Generator(card).manual_seed(5)
    cam, proj = (torch.rand((1, 48, 160), generator=g, device=card)
                 for _ in range(2))
    cfg = dict(kernel_size=7, num_disparities=24)
    cam_k = cam.clone().requires_grad_(True)
    before = COUNTS.copy()
    StereoMatcher(StereoConfig(**cfg))(cam_k, proj) \
        .soft_disparity.mean().backward()
    assert COUNTS - before == Counter({"K1": 1, "K8h": 1, "K8hb": 1,
                                       "K2": 1})
    cam_p = cam.cpu().requires_grad_(True)
    StereoMatcher(StereoConfig(backend="torch", **cfg))(
        cam_p, proj.cpu()).soft_disparity.mean().backward()
    want = cam_p.grad.to(card)
    torch.testing.assert_close(cam_k.grad, want, **_grad_tol(want))


@pytest.mark.card
def test_card_head_all_pairs_rows_past_one_tile(card):
    """All-pairs at W = 1242 (L = 1242: three row tiles, 8-byte loads)."""
    _card_check(card, _volume((1, 4, 1242, None)).to(card), None, 4)


@pytest.mark.card
def test_card_head_refuses_strided_volumes(card):
    x = torch.zeros((1, 4, 7, 3), device=card).transpose(2, 3)
    before = COUNTS.copy()
    with pytest.raises(ValueError, match="strided"):
        extract_disparity_cuda(x, 2)
    assert COUNTS == before
