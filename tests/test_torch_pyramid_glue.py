"""PyTorch port, the pyramid's glue: the plain twins of K11p / K11w /
K11c's one-pass arithmetic held against the plain glue of
``models/pyramid.py`` on the CPU, the matcher's routing of each stage and
its ``plain.pyramid_<stage>`` counts, the wrappers' refusals; on the card,
K11w and K11c bit-equal to the plain glue and K11p within rtol 1e-6 of
``_avg_pool``, and a pyramid call launching the three kernels.

The file imports no JAX, so on the card: ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_pyramid_glue.py -q``.
"""

import re
from collections import Counter

import pytest
import torch

from custereomatching_tpu_torch import StereoConfig
from custereomatching_tpu_torch.models import PyramidStereoMatcher
from custereomatching_tpu_torch.models import pyramid
from custereomatching_tpu_torch.ops import _build, cuda_pyramid
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps
from custereomatching_tpu_torch.utils.profiling import COUNTS

# K11p sums each block in row-major order, torch's mean in its own order.
POOL_TOL = dict(rtol=1e-6, atol=0.0)

# (B, H, W, f): H and W off a multiple of f; (2, 8, 48, 4) takes K11p's
# 16-byte loads (f = 4, W % 4 == 0); (1, 1, 5, 4) a single row.
POOL_CASES = [(1, 13, 37, 2), (2, 13, 37, 4), (1, 9, 22, 3), (2, 8, 48, 4),
              (1, 1, 5, 4)]
# (B, H, W, f, r, D)
WARP_CASES = [(1, 13, 37, 4, 3, 20), (2, 10, 41, 2, 2, 9),
              (2, 16, 64, 4, 12, 40)]
# (B, H, W, r)
COMPOSE_CASES = [(1, 7, 33, 3), (2, 5, 40, 2), (2, 9, 64, 12)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _pool_inputs(case, seed=0):
    B, H, W, f = case
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, H, W), generator=g),
            torch.rand((B, H, W), generator=g))


def _warp_inputs(case, seed=0):
    """A projector and a coarse soft map whose shifts reach both clamp
    ends (round(c f) - r below -r and above D), halves that round to even,
    columns out of view on both sides, and one NaN."""
    B, H, W, f, r, D = case
    g = torch.Generator().manual_seed(seed)
    h, w = -(-H // f), -(-W // f)
    proj = torch.randn((B, H, W), generator=g)
    lo, hi = -2.0, (D + r) / f + 2.0
    coarse = lo + (hi - lo) * torch.rand((B, h, w), generator=g)
    coarse[:, 0, :3] = torch.tensor([(r + 0.5) / f, (r + 1.5) / f,
                                     (r - 2.5) / f])
    coarse[0, -1, -1] = float("nan")
    return proj, coarse


def _compose_inputs(case, seed=0):
    """The fine level's maps and a shift: band indices outside [0, 2r]
    (and halves about them), columns out of view on the left, negative
    totals, a mask of zeros and ones, NaN in the soft map."""
    B, H, W, r = case
    g = torch.Generator().manual_seed(seed)
    shape = (B, H, W)
    hard = torch.randint(-3, 2 * r + 4, shape, generator=g).float()
    soft = -3.0 + (2 * r + 6) * torch.rand(shape, generator=g)
    soft[:, 0, :4] = torch.tensor([-0.5, 2 * r + 0.5, 0.5, -0.4])
    soft[0, 1, 1] = float("nan")
    mask = torch.randint(0, 2, shape, generator=g).float()
    mask[:, 0] = 1.0
    shift = torch.randint(-r, 3 * r, shape, generator=g).float()
    fine = PipelineMaps(hard * mask, soft * mask, mask,
                        torch.rand(shape, generator=g))
    return fine, shift


def pool_twin(img: torch.Tensor, f: int) -> torch.Tensor:
    """K11p's arithmetic: each block summed in row-major order from 0,
    edge rows and columns repeated, times 1 / f^2."""
    H, W = img.shape[-2:]
    Hc, Wc = -(-H // f), -(-W // f)
    rows = torch.arange(Hc * f).clamp(max=H - 1).view(Hc, f)
    cols = torch.arange(Wc * f).clamp(max=W - 1).view(Wc, f)
    acc = torch.zeros(img.shape[:-2] + (Hc, Wc), dtype=img.dtype)
    for i in range(f):
        for j in range(f):
            acc = acc + img[..., rows[:, i], :][..., cols[:, j]]
    return acc * torch.tensor(1.0 / (f * f), dtype=img.dtype)


def warp_twin(proj, coarse, f, r, D):
    """K11w's arithmetic, a pixel at a time as the kernel has it:
    ``coarse[y // f, x // f]``, rounded, clamped; a NaN shift reads the
    column x (k = 0), as the JAX package's int32 cast of a NaN gives 0."""
    H, W = proj.shape[-2:]
    ys, xs = torch.arange(H) // f, torch.arange(W) // f
    c = coarse[..., ys, :][..., xs]
    s = torch.clamp(torch.round(c * f) - r, -r, D)
    k = torch.where(torch.isnan(s), 0.0, s).to(torch.int64)
    col = torch.arange(W) - k
    ok = (col >= 0) & (col < W) & (k >= -r) & (k <= D)
    picked = torch.gather(proj, -1, torch.where(ok, col, 0))
    return s, torch.where(ok, picked, 0.0)


def compose_twin(fine: PipelineMaps, shift: torch.Tensor, r: int):
    """K11c's arithmetic: the band index's range tested in float (NaN
    fails it and reads 0), then the column; sums and products in fp32."""
    W = shift.shape[-1]

    def total(d):
        k = torch.round(d)
        inside = (k >= 0) & (k <= 2 * r)
        col = torch.arange(W) - torch.where(inside, k, 0.0).to(torch.int64)
        ok = inside & (col >= 0)
        s = torch.where(ok, torch.gather(shift, -1, col.clamp(min=0)), 0.0)
        return (s + d) * fine.mask

    th, ts = total(fine.disparity), total(fine.soft_disparity)
    keep = torch.where((th < 0) | (ts < 0), 0.0, fine.mask)
    return PipelineMaps(torch.clamp_min(th, 0.0) * keep,
                        torch.clamp_min(ts, 0.0) * keep, keep,
                        fine.confidence)


# ---------------------------------------------------------------------------
# The twins against the plain glue, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool_twin_matches_avg_pool(case):
    f = case[-1]
    for img in _pool_inputs(case):
        torch.testing.assert_close(pool_twin(img, f),
                                   pyramid._avg_pool(img, f), **POOL_TOL)


@pytest.mark.parametrize("case", WARP_CASES, ids=str)
def test_warp_twin_is_the_plain_warp(case):
    """Bit for bit; the inputs reach both clamp ends, both sides out of
    view and a NaN shift, which reads the projector's own column."""
    _, H, W, f, r, D = case
    proj, coarse = _warp_inputs(case)
    shift, proj_w = pyramid._shift_and_warp(proj, coarse, f, r, D)
    t_shift, t_proj_w = warp_twin(proj, coarse, f, r, D)
    assert _bit_equal(shift, t_shift) and _bit_equal(proj_w, t_proj_w)
    finite = ~torch.isnan(shift)
    assert not finite.all()
    assert torch.equal(proj_w[~finite], proj[~finite])
    assert (shift == -r).any() and (shift == D).any()
    col = torch.arange(W) - shift
    assert (finite & (col < 0)).any() and (finite & (col >= W)).any()


@pytest.mark.parametrize("case", COMPOSE_CASES, ids=str)
def test_compose_twin_is_the_plain_compose(case):
    """Bit for bit, NaN where the plain compose has NaN; the inputs hold
    band indices outside [0, 2r], columns out of view and pixels whose
    total is negative in one map only."""
    _, H, W, r = case
    fine, shift = _compose_inputs(case)
    got = compose_twin(fine, shift, r)
    want = pyramid._compose(fine, shift, r)
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert _bit_equal(torch.nan_to_num(a), torch.nan_to_num(b))
    k = torch.round(fine.soft_disparity)
    assert ((k < 0) | (k > 2 * r)).any()
    assert (torch.arange(W) - torch.round(fine.disparity) < 0).any()
    th = (shift + fine.disparity) * fine.mask
    ts = (shift + fine.soft_disparity) * fine.mask
    assert ((th < 0) & (ts >= 0)).any() and ((ts < 0) & (th >= 0)).any()


# ---------------------------------------------------------------------------
# The matcher's routing, on the CPU
# ---------------------------------------------------------------------------

def _matcher():
    return PyramidStereoMatcher(StereoConfig(num_disparities=12,
                                             kernel_size=5),
                                downsample=2, residual=3)


@pytest.mark.parametrize("stage", ["pool", "warp", "compose"])
def test_each_stage_takes_the_plain_glue_on_the_cpu(stage):
    """Each stage method on CPU tensors is its plain function, counted
    once, and launches nothing."""
    pyr = _matcher()
    f, r, D = pyr.downsample, pyr.residual, pyr.config.num_disparities
    before = COUNTS.copy()
    if stage == "pool":
        cam, proj = _pool_inputs((2, 13, 37, f))
        got = pyr.coarse_pair(cam, proj)
        want = (pyramid._avg_pool(cam, f), pyramid._avg_pool(proj, f))
    elif stage == "warp":
        proj, coarse = _warp_inputs((2, 13, 37, f, r, D))
        got = pyr.warp(proj, coarse)
        want = pyramid._shift_and_warp(proj, coarse, f, r, D)
    else:
        fine, shift = _compose_inputs((2, 7, 33, r))
        got = pyr.compose(fine, shift)
        want = pyramid._compose(fine, shift, r)
    assert COUNTS - before == Counter({f"plain.pyramid_{stage}": 1})
    for a, b in zip(got, want):
        assert _bit_equal(a, b)


def test_card_backend_routes_each_stage_to_its_kernel(monkeypatch):
    """With the backend resolving to ``cuda``, each stage calls its
    kernel's wrapper with the matcher's f, r and D (here the twins stand
    in for the kernels) and counts no plain stage."""
    calls = []

    def stub(name, twin):
        def fn(*args):
            calls.append((name, args[2:]))
            return twin(*args)
        return fn

    monkeypatch.setattr(PyramidStereoMatcher, "_on_card",
                        lambda self, x: True)
    monkeypatch.setattr(cuda_pyramid, "pool_pair", stub(
        "pool", lambda c, p, f: (pool_twin(c, f), pool_twin(p, f))))
    monkeypatch.setattr(cuda_pyramid, "shift_and_warp",
                        stub("warp", warp_twin))
    monkeypatch.setattr(cuda_pyramid, "compose", stub("compose",
                                                      compose_twin))
    g = torch.Generator().manual_seed(2)
    cam, proj = (torch.rand((1, 16, 30), generator=g) for _ in range(2))
    before = COUNTS.copy()
    _matcher()(cam, proj)
    ran = COUNTS - before
    assert not any(name.startswith("plain.pyramid") for name in ran)
    assert calls == [("pool", (2,)), ("warp", (2, 3, 12)),
                     ("compose", (3,))]


def test_entry_points_take_the_arguments_ctypes_passes():
    """Each C entry of ``csrc/pyramid_glue.cu`` declares as many
    parameters, pointers where pointers, as ``_build.SIGNATURES`` gives
    ctypes."""
    text = (_build.CSRC / "pyramid_glue.cu").read_text()
    found = dict(re.findall(r'extern "C" int (custereo_pyramid_\w+)'
                            r'\(([^)]*)\)', text))
    assert set(found) == {"custereo_pyramid_pool", "custereo_pyramid_warp",
                          "custereo_pyramid_compose"}
    for name, params in found.items():
        kinds = [_build._P if "*" in p else _build._I
                 for p in params.split(",")]
        assert kinds == _build.SIGNATURES[name], name


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA float32 tensors only: a CPU tensor
    raises ``ValueError`` before any launch."""
    x = torch.zeros((1, 8, 8))
    before = COUNTS.copy()
    with pytest.raises(ValueError, match="CUDA float32"):
        cuda_pyramid.pool_pair(x, x, 2)
    with pytest.raises(ValueError, match="CUDA float32"):
        cuda_pyramid.shift_and_warp(x, torch.zeros((1, 4, 4)), 2, 1, 4)
    with pytest.raises(ValueError, match="CUDA float32"):
        cuda_pyramid.compose(PipelineMaps(x, x, x, x), x, 1)
    assert COUNTS == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_card_pool_matches_avg_pool(card, case):
    f = case[-1]
    cam, proj = (t.to(card) for t in _pool_inputs(case, seed=3))
    before = COUNTS.copy()
    got = cuda_pyramid.pool_pair(cam, proj, f)
    assert COUNTS - before == Counter({"K11p": 1})
    for a, img in zip(got, (cam, proj)):
        torch.testing.assert_close(a, pyramid._avg_pool(img, f), **POOL_TOL)


@pytest.mark.card
@pytest.mark.parametrize("case", WARP_CASES, ids=str)
def test_card_warp_is_the_plain_warp_bit_for_bit(card, case):
    _, H, W, f, r, D = case
    proj, coarse = (t.to(card) for t in _warp_inputs(case, seed=4))
    before = COUNTS.copy()
    got = cuda_pyramid.shift_and_warp(proj, coarse, f, r, D)
    assert COUNTS - before == Counter({"K11w": 1})
    want = pyramid._shift_and_warp(proj, coarse, f, r, D)
    for a, b in zip(got, want):
        assert _bit_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("case", COMPOSE_CASES, ids=str)
def test_card_compose_is_the_plain_compose_bit_for_bit(card, case):
    _, H, W, r = case
    fine, shift = _compose_inputs(case, seed=5)
    fine = PipelineMaps(*(t.to(card) for t in fine))
    shift = shift.to(card)
    before = COUNTS.copy()
    got = cuda_pyramid.compose(fine, shift, r)
    assert COUNTS - before == Counter({"K11c": 1})
    want = pyramid._compose(fine, shift, r)
    for a, b in zip(got, want):
        assert _bit_equal(a, b)
    assert got.confidence is fine.confidence


@pytest.mark.card
def test_card_pyramid_call_launches_the_glue_kernels(card):
    """A pyramid call on the card: K3 twice and K11p, K11w, K11c once, no
    plain glue; the maps are the plain glue's around the same K3 levels,
    bit for bit past the pool."""
    g = torch.Generator().manual_seed(6)
    cam, proj = (torch.rand((2, 48, 130), generator=g).to(card)
                 for _ in range(2))
    pyr = PyramidStereoMatcher(StereoConfig(num_disparities=40,
                                            kernel_size=7),
                               downsample=4, residual=5)
    before = COUNTS.copy()
    with torch.no_grad():
        got = pyr(cam, proj)
    assert COUNTS - before == Counter({"K3": 2, "K11p": 1, "K11w": 1,
                                       "K11c": 1})
    f, r, D = pyr.downsample, pyr.residual, pyr.config.num_disparities
    with torch.no_grad():
        coarse = pyr._coarse.disparity_maps(*pyr.coarse_pair(cam, proj))
        shift, proj_w = pyramid._shift_and_warp(proj, coarse.soft_disparity,
                                                f, r, D)
        want = pyramid._compose(pyr._fine.disparity_maps(cam, proj_w),
                                shift, r)
    for a, b in zip(got, want):
        assert _bit_equal(a, b)
