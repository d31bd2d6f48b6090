"""PyTorch port: the register-blocked window pass of K1-K7
(``csrc/common.cuh`` ``window_taps``, ``csrc/fused_pipeline.cuh``,
``csrc/fused_pipeline_bwd.cu``, ``csrc/camera_grad.cuh``,
``csrc/zncc_banded_bwd.cu``, ``csrc/zncc_banded_proj_bwd.cu``), the routes
that take every odd k <= 127 (K4's constants read from their maps, the
chunked route of K5 and K6, K7's combine a map at a time) and K8's
strips of row products (``csrc/zncc_allpairs.cu``).  The kernels need the
card
(``chip_smoke.py``); here their control flow is mirrored in Python and
held to what the sources and the bound model say: every output takes its
k taps in order, the groups of a line cover it without reading past it,
the Python mirrors of the blocking constants are the sources', and the
shared memory and cost counts stay pinned."""

import re
from pathlib import Path

import pytest

from custereomatching_tpu_torch.utils import kernel_model as km

CSRC = Path(km.__file__).resolve().parents[1] / "csrc"
H, W, D, K = 375, 1242, 192, 15
LIMIT = km.SMEM_OPTIN_BYTES // 4
# K4's and K6's counts on the rounds kernel (madd, smem, exp, rsqrt), at a
# small shape and at KITTI.
PIN_K4_SMALL = {"madd": 1128376, "smem": 1269424, "exp": 70784,
                "rsqrt": 75208}
PIN_K4_KITTI = {"madd": 2566914220, "smem": 2015143110, "exp": 210215200,
                "rsqrt": 211266276}
PIN_K6_SMALL = {"madd": 792416, "smem": 1640464, "exp": 0, "rsqrt": 70784}
PIN_K6_KITTI = {"madd": 2794654992, "smem": 2497244124, "exp": 0,
                "rsqrt": 210215200}
# K1's and K7's on the rounds of the register-blocked pass.
PIN_K1_SMALL = {"madd": 289200, "smem": 736752, "exp": 0, "rsqrt": 39600}
PIN_K1_KITTI = {"madd": 1895194440, "smem": 884046870, "exp": 0,
                "rsqrt": 89889750}
PIN_K7_SMALL = {"madd": 478576, "smem": 1102584, "exp": 0, "rsqrt": 47656}
PIN_K7_KITTI = {"madd": 997857592, "smem": 1836900202, "exp": 0,
                "rsqrt": 188070116}
# K2's on the rounds kernel (the cost read at the tile's own pixels).
PIN_K2_SMALL = {"madd": 619616, "smem": 1198432, "exp": 0, "rsqrt": 70784}
PIN_K2_KITTI = {"madd": 1092254592, "smem": 1937586054, "exp": 0,
                "rsqrt": 210215200}
# K4's, K5's, K6's and K7's past their old limits (K4's constants from their
# maps, K5's and K6's chunked route, K7's combine a map at a time), at a
# small shape one k past the limit and at KITTI with k = 127.
PIN_K4_K49 = {"madd": 39953024, "smem": 11120080, "exp": 639744,
              "rsqrt": 799680}
PIN_K4_K127 = {"madd": 74307889294, "smem": 25482721964, "exp": 2119940564,
               "rsqrt": 4239881128}
PIN_K5_K29 = {"madd": 38704004, "smem": 8721904, "exp": 391500,
              "rsqrt": 584140}
PIN_K5_K127 = {"madd": 122571901714, "smem": 31455587114,
               "exp": 2119940564, "rsqrt": 4329770878}
PIN_K6_K83 = {"madd": 132197264, "smem": 21779108, "exp": 0,
              "rsqrt": 895000}
PIN_K6_K127 = {"madd": 101372496074, "smem": 17304256616, "exp": 0,
               "rsqrt": 2209830314}
PIN_K7_K95 = {"madd": 83041400, "smem": 22363160, "exp": 0, "rsqrt": 869640}
PIN_K7_K127 = {"madd": 55353599246, "smem": 8605683222, "exp": 0,
               "rsqrt": 2064040132}


def _k7_combine_floats(k: int, at_once: int = 3) -> int:
    """Shared memory of K7's combine kernel in floats: three halo'd tiles
    and their rows passes; that of K2's, K4's and K6's with ``at_once``
    maps staged together (``combine_floats`` of camera_grad.cuh)."""
    p = k // 2
    return at_once * (16 + 2 * p + 16) * (64 + 2 * p)


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def test_blocking_constants_mirror_the_sources():
    common = (CSRC / "common.cuh").read_text()
    # K4's launcher lives in head_rounds.cuh, which its tiles' translation
    # units share with fused_pipeline_bwd.cu.
    bwd = ((CSRC / "fused_pipeline_bwd.cu").read_text()
           + (CSRC / "head_rounds.cuh").read_text())
    grad = (CSRC / "camera_grad.cuh").read_text()
    proj = (CSRC / "zncc_banded_proj_bwd.cu").read_text()
    volume = (CSRC / "zncc_banded.cu").read_text()
    fused = (CSRC / "fused_pipeline.cuh").read_text()
    k2 = (CSRC / "zncc_banded_bwd.cu").read_text()
    allpairs = (CSRC / "zncc_allpairs.cu").read_text()
    assert (_const(common, "kRoundRows"), _const(common, "kRoundCols")) == (
        km.ROUND_ROWS, km.ROUND_COLS)
    assert tuple(_const(bwd, n) for n in (
        "kHaloRows", "kHaloCols", "kHaloOwn", "kHaloConsts")) == (
            km.HALO_ROWS, km.HALO_COLS, km.HALO_OWN, km.HALO_CONSTS)
    assert tuple(_const(grad, n) for n in (
        "kGradRows", "kGradCols", "kGradPlanes")) == (
            km.GRAD_ROWS, km.GRAD_COLS, km.GRAD_PLANES)
    assert tuple(_const(allpairs, n) for n in (
        "kApWarps", "kApXPerThread", "kApYPerThread", "kApRows")) == (
            km.AP_WARPS, km.AP_X_PER_THREAD, km.AP_Y_PER_THREAD, km.AP_ROWS)
    assert (_const(grad, "kCostChunk"), *(_const(
        (CSRC / "layout.cu").read_text(), n) for n in (
            "kParityPixels", "kParityThreads", "kParityChunk"))) == (
        km.COST_CHUNK, km.PARITY_PIXELS, km.PARITY_THREADS, km.PARITY_CHUNK)
    # K2 is the rounds kernel's third instantiation, K6's source reading
    # the cost at the tile's own pixels; past its recomputing block K6
    # takes the chunked route on K2's instantiation, and past its staged
    # constants K4 reads them from their maps; the per-plane kernel is
    # gone, and K8 sums its rows with window_taps' loops.
    assert "launch_all_planes<CotangentSource<true>, false>(" in k2
    assert "launch_all_planes<Recompute, true>(" in k2
    assert "launch_cost_slabs<CotangentSource<true>>(" in k2
    assert "launch_cost_slabs<Source>(" in bwd
    assert "launch_all_planes<Unstaged, false>(" in bwd
    assert "launch_fused<false, false, false, true, true>(" in grad
    for name in ("camera_grad_planes_kernel", "GradTile(",
                 "launch_camera_grad("):
        assert name not in grad + k2
    assert "window_sweep(acc, k, row_products," in allpairs
    assert "vertical_sum(vsum" not in k2 + allpairs
    # gr's passes exist once, in camera_grad.cuh, and K5 calls them there.
    assert "void grad_rows(" not in bwd and "grad_rows(xbuf, ybuf, x.grad()" \
        in bwd
    # The rounds kernel is instantiated at every power of two up to
    # kGradPlanes, the planes grad_round may give.
    planes = km.GRAD_PLANES
    while planes >= 1:
        assert f"case {planes}:" in grad and (
            f"launch_rounds<Source, kRecompute, kSlab, {planes}>" in grad)
        # K7's rounds kernel too.
        assert f"case {planes}:" in proj and (
            f"launch_proj_rounds<{planes}>" in proj)
        planes //= 2
    # K1 is K3's rounds kernel without the head, through the shared
    # launcher; neither it nor K7 runs K1's first pass any more, and K7's
    # gr passes are camera_grad.cuh's.
    assert "run_pipeline<false, false, true>(" in volume
    assert '#include "fused_pipeline.cuh"' in volume
    for text in (volume, fused, proj):
        assert "vertical_products(" not in text
        assert "vertical_sum(vsum" not in text
    assert "horizontal_sum(" not in volume + fused
    assert "grad_rows(xbuf, ybuf, gs, k, np);" in proj
    assert "void grad_rows(" not in proj and "void ring_entry(" not in proj
    # The launcher sizes the round for the planes it walks, through
    # fused_rounds_at, which the C query of the route pin shares.
    assert "fused_rounds_at(k, d_hi - d_lo," in fused and (
        "*round = fused_round(k, D," in fused) and "staging_chunk(" in common
    # K3's rows pass covers the tile height; gr's groups tile the tile.
    assert km.ROUND_ROWS == km.K_TILE_H and km.K_TILE_W % km.ROUND_COLS == 0
    assert km.K_TILE_H % km.GRAD_ROWS == 0
    assert km.K_TILE_W % km.GRAD_COLS == 0


def _tap_order(n_out: int, k: int):
    """The line entries each output of ``window_taps<N>`` adds, in the
    order it adds them (the source's three loops for k >= N - 1, the
    predicated loop otherwise)."""
    taps = [[] for _ in range(n_out)]
    if k >= n_out - 1:
        for i in range(n_out - 1):
            for n in range(i + 1):
                taps[n].append(i)
        for i in range(n_out - 1, k):
            for n in range(n_out):
                taps[n].append(i)
        for j in range(n_out - 1):
            for n in range(j + 1, n_out):
                taps[n].append(k + j)
    else:
        for i in range(n_out - 1 + k):
            for n in range(n_out):
                if 0 <= i - n < k:
                    taps[n].append(i)
    return taps


@pytest.mark.parametrize("n_out, k", [
    (16, 15), (16, 17), (16, 3), (16, 7), (15, 15), (15, 14), (15, 13),
    (13, 15), (13, 11), (8, 27), (8, 7), (8, 5), (16, 16)])
def test_window_taps_add_each_output_taps_in_order(n_out, k):
    """Output n adds line entries n, n + 1, ..., n + k - 1 in that order
    (t = 0..k-1, as vertical_products and horizontal_sum), reads no entry
    past N + k - 2, and the k >= N - 1 loops add exactly N k taps."""
    taps = _tap_order(n_out, k)
    assert taps == [list(range(n, n + k)) for n in range(n_out)]
    assert max(max(t) for t in taps) == n_out + k - 2


def _group_starts(n: int, length: int):
    return [min(q * n, length - n) for q in range(-(-length // n))]


@pytest.mark.parametrize("k", [3, 5, 11, 15, 25, 27])
def test_groups_cover_every_line_without_reading_past_it(k):
    """``group_start``: the groups of K5's halo rows (15), halo columns
    (13) and K3's / K5's tile lines cover every output once or twice and
    stay inside the line; their reads stay inside the staged tiles."""
    p = k // 2
    for n, length, staged in (
            (km.HALO_ROWS, 16 + 2 * p, 16 + 4 * p),   # cross-term rows
            (km.HALO_COLS, 64 + 2 * p, 64 + 4 * p),   # its column sums
            (km.GRAD_ROWS, 16, 16 + 2 * p),           # gr's rows pass
            (km.GRAD_COLS, 64, 64 + 2 * p),           # gr's column sums
            (km.ROUND_ROWS, 16, 16 + 2 * p),          # K3's rows pass
            (km.ROUND_COLS, 64, 64 + 2 * p)):         # K3's column sums
        starts = _group_starts(n, length)
        covered = {s + i for s in starts for i in range(n)}
        assert covered == set(range(length))
        assert all(0 <= s and s + n <= length for s in starts)
        assert max(starts) + n + k - 1 <= staged


def test_shared_memory_of_the_blocks():
    """The source notes' counts: K1 and K3 at KITTI 40,392 floats (13 planes
    a round, the projector's 193 planes staged at once), K5 58,072 (5
    planes a round, chunks of 125); K5's halo kernel still takes k <= 27;
    past D = 782 at k = 15 K1 and K3 stage the projector in chunks of 780
    planes (60 rounds), so no D is refused (K3 stopped at 1704, K1 at
    1739)."""
    assert km.fused_round(K, D) == (13, D + 1)
    assert km.fused_block_floats(K, D) == 40392 <= LIMIT
    assert km.fused_round(K, 782) == (13, 783)
    assert km.fused_round(K, 783) == (13, 780)
    for d in (1704, 1705, 1739, 1740, 4000):
        assert km.fused_round(K, d) == (13, 780)
        assert km.fused_block_floats(K, d) == 30 * (156 + 779) + 13 * 2304
    assert km.halo_tile(K, 125, 5)["floats"] == 58072 <= LIMIT
    assert km.halo_tile(27, 1, 1)["floats"] == 54752
    assert km.halo_tile(29, 1, 1)["floats"] == 59080
    assert km.halo_tile(27, 1, 1)["halo"] <= km.HALO_OWN * km.K_THREADS
    assert km.halo_fits(27, D) and not km.halo_fits(29, D)


def test_shared_memory_of_the_rounds_kernel():
    """K4 at KITTI: P = 8, 45,452 floats; K6: P = 8, all 193 planes of the
    projector at once, 41,852 floats, in chunks of 728 at D = 1600; K4
    falls to P = 4 at k = 27 and P = 1 at k = 47 (56,398 floats), where
    the planes kernel it replaced stopped too; from k = 49 its constants
    stay in their maps, and one plane's buffers fit up to k = 127 (30,178
    floats).  K6's recomputing block fits up to k = 81 (59,682 floats at
    k = 83)."""
    assert km.grad_round(K, D, True, False) == (8, D + 1)
    assert km.grad_round_tile(K, D + 1, 8, head=True,
                              recompute=False)["floats"] == 45452
    assert km.grad_round(K, D, False, True) == (8, D + 1)
    assert km.grad_round_tile(K, D + 1, 8, head=False,
                              recompute=True)["floats"] == 41852
    assert km.grad_round(K, 1600, False, True) == (8, 728)
    assert km.grad_round(27, D, True, False) == (4, D + 1)
    assert km.grad_round(47, D, True, False) == (1, D + 1)
    assert km.grad_round_tile(47, 1, 1, head=True,
                              recompute=False)["floats"] == 56398 <= LIMIT
    assert km.grad_round(49, D, True, False) == (0, 0)
    p = 49 // 2
    assert 8 * (16 + 2 * p) * (64 + 2 * p) + 16 * (64 + 2 * p) > LIMIT
    assert not km.k4_staged(49, D) and km.k4_staged(47, D)
    assert km.grad_round(49, D, True, False, staged=False) == (4, D + 1)
    assert km.grad_round(127, D, True, False, staged=False) == (1, D + 1)
    assert km.grad_round_tile(127, 1, 1, head=True, recompute=False,
                              staged=False)["floats"] == 30178
    assert km.grad_round(81, D, False, True)[0] == 1
    assert km.grad_round(83, D, False, True) == (0, 0)
    assert km.grad_round_tile(83, 1, 1, head=False,
                              recompute=True)["floats"] == 59682


@pytest.mark.parametrize("k", list(range(3, 49, 2)))
def test_k4_and_k6_take_every_k_they_took(k):
    """Every odd k up to 47 ran on the planes kernel before the rounds
    kernel: K4 at D = 192, K6 at every D.  The mirrored geometry gives at
    least one plane a round there, a power of two up to kGradPlanes, a
    chunk that is D + 1 or a multiple of the round, and a block that fits
    227 KB."""
    for head, recompute, ds in ((True, False, (D,)),
                                (False, True, (0, D, 1600))):
        for d in ds:
            planes, chunk = km.grad_round(k, d, head, recompute)
            assert planes >= 1 and planes & (planes - 1) == 0
            assert planes <= km.GRAD_PLANES and (planes == 1
                                                 or planes <= d + 1)
            assert 1 <= chunk <= d + 1
            assert chunk == d + 1 or chunk % planes == 0
            t = km.grad_round_tile(k, chunk, planes, head=head,
                                   recompute=recompute)
            assert t["floats"] <= LIMIT


@pytest.mark.parametrize("k", [3, 5, 7, 11, 15, 21, 27])
def test_rounds_fit_the_block(k):
    """A K3 round gives each thread at most one rows-pass column; a K5
    round at most one rows-pass item; both blocks fit 227 KB."""
    for d in (0, 6, 192, 600):
        planes, _ = km.fused_round(k, d)
        assert 1 <= planes <= d + 1
        assert planes == 1 or planes * (64 + 2 * (k // 2)) <= km.K_THREADS
        assert km.fused_block_floats(k, d) <= LIMIT
        hp, chunk = km.halo_round(k, d)
        t = km.halo_tile(k, chunk, hp)
        assert 1 <= hp <= chunk <= d + 1
        assert chunk == d + 1 or chunk % hp == 0
        assert hp == 1 or hp * t["img_w"] * t["row_groups"] <= km.K_THREADS
        assert t["floats"] <= LIMIT


def test_window_pass_cost_counts_the_binding_pipe():
    """K3's rows pass at k = 15: 76 shared accesses an item against 240
    FMAs, so its accesses bind; its column sums: 46 against 240 adds, so
    the adds bind (four FMAs an access)."""
    rows = km.window_pass_cost(10, 16, 15, True)
    assert rows["smem"] == 10 * (2 * 30 + 16) and rows["madd"] == 0
    cols = km.window_pass_cost(10, 16, 15, False)
    assert cols["madd"] == 10 * 16 * 15 and cols["smem"] == 0


@pytest.mark.parametrize("fn, shape, want", [
    ("volume_forward_cost", (24, 150, 10, 5), PIN_K1_SMALL),
    ("volume_forward_cost", (H, W, D, K), PIN_K1_KITTI),
    ("projector_backward_cost", (24, 150, 10, 5), PIN_K7_SMALL),
    ("projector_backward_cost", (H, W, D, K), PIN_K7_KITTI),
    ("fused_backward_c_cost", (24, 150, 10, 5), PIN_K4_SMALL),
    ("fused_backward_c_cost", (H, W, D, K), PIN_K4_KITTI),
    ("k6_cost", (24, 150, 10, 5), PIN_K6_SMALL),
    ("k6_cost", (H, W, D, K), PIN_K6_KITTI),
    ("volume_backward_cost", (24, 150, 10, 5), PIN_K2_SMALL),
    ("volume_backward_cost", (H, W, D, K), PIN_K2_KITTI),
    ("fused_forward_cost", (24, 150, 10, 5),
     {"madd": 422400, "smem": 736752, "exp": 39600, "rsqrt": 43200}),
    ("fused_forward_cost", (H, W, D, K),
     {"madd": 2166726690, "smem": 884046870, "exp": 89889750,
      "rsqrt": 90355500}),
    ("fused_backward_cost", (24, 150, 10, 5),
     {"madd": 950112, "smem": 1986968, "exp": 48664, "rsqrt": 53088}),
    ("fused_backward_cost", (H, W, D, K),
     {"madd": 6255793512, "smem": 3515970318, "exp": 202857668,
      "rsqrt": 203908744})])
def test_counts_of_the_redesigned_kernels(fn, shape, want):
    """K1's, K2's, K3's, K4's, K5's, K6's and K7's counts at a small shape
    and at KITTI, pinned: no ``boxadd`` (that is K1's first pass), no
    volume written but K1's."""
    cost = (km.volume_backward_cost(*shape, with_cost=False)
            if fn == "k6_cost" else getattr(km, fn)(*shape))
    assert {m: cost[m] for m in want} == want and cost["boxadd"] == 0
    h, w, d, _ = shape
    volume = 4 * (d + 1) * h * w
    written = cost.bytes_w - (volume if fn == "volume_forward_cost" else 0)
    assert 0 < written < volume


def test_k5_needs_a_block_that_fits():
    """K5's halo kernel needs a block that fits (k <= 27); at k = 29 its
    count is the chunked route's: the statistics passes, the combine, K1's
    rounds over each slab and K4's rounds kernel on it, which is more work
    than K4's on a saved volume by K1's rounds and the slabs' store."""
    assert not km.halo_fits(29, 16)
    free = km.fused_backward_cost(40, 120, 16, 29)
    saved = km.fused_backward_c_cost(40, 120, 16, 29)
    assert free["madd"] > saved["madd"] and free["smem"] > saved["smem"]
    assert free.bytes_w > saved.bytes_w


@pytest.mark.parametrize("k", list(range(3, 129, 2)))
def test_k1_and_k7_take_every_k_at_every_d(k):
    """K1 takes every odd k <= 127 at every D (the first version refused
    D >= 1740 at k = 15): its mirrored round and projector chunk give at
    least one plane, no more than D + 1, a chunk that is D + 1 or a
    multiple of the round, and a block that fits 227 KB.  K7 takes every
    odd k <= 127 at any D: its rounds fall as far as one plane (a power of
    two up to kGradPlanes) and its block fits; its combine kernel stages
    the three maps together up to k = 93 (the first version's limit) and
    one at a time beyond, and fits either way."""
    for d in (0, 192, 1739, 1740, 4000):
        planes, chunk = km.fused_round(k, d)
        assert 1 <= planes <= d + 1 and 1 <= chunk <= d + 1
        assert chunk == d + 1 or chunk % planes == 0
        assert km.fused_block_floats(k, d) <= LIMIT
        assert (_k7_combine_floats(k) <= LIMIT) == (k <= 93)
        assert _k7_combine_floats(k, 1) <= LIMIT
        p7, c7 = km.grad_round(k, d, False, False)
        assert 1 <= p7 <= km.GRAD_PLANES and p7 & (p7 - 1) == 0
        assert p7 == 1 or p7 <= d + 1
        assert c7 == d + 1
        assert km.grad_round_tile(k, 1, p7, head=False,
                                  recompute=False)["floats"] <= LIMIT
    # K1's block at k = 127: one plane a round and a one-plane chunk, 56
    # floats under the limit; k = 129 does not fit (nor did it before).
    if k == 127:
        assert km.fused_round(k, 4000) == (1, 1)
        assert km.fused_block_floats(k, 4000) == 58056 == LIMIT - 56


@pytest.mark.parametrize("k", list(range(3, 129, 2)))
def test_k2_takes_every_k_at_every_d(k):
    """K2, on the rounds kernel, takes every odd k <= 127 at every D, as
    the per-plane kernel it replaced did: its rounds (ex2 its one staged
    map, no recompute) fall as far as one plane, a power of two up to
    kGradPlanes, at all D + 1 planes, and its block fits 227 KB (57,158
    floats at k = 127); its combine kernel stages the three maps together
    up to k = 93 and one at a time beyond, and fits either way."""
    for d in (0, 192, 1739, 1740, 4000):
        planes, chunk = km.grad_round(k, d, False, False)
        assert 1 <= planes <= km.GRAD_PLANES and planes & (planes - 1) == 0
        assert planes == 1 or planes <= d + 1
        assert chunk == d + 1
        assert km.grad_round_tile(k, 1, planes, head=False,
                                  recompute=False)["floats"] <= LIMIT
    together = _k7_combine_floats(k) <= LIMIT
    assert together == (k <= 93)
    assert _k7_combine_floats(k, 1) <= LIMIT
    if k == 127:
        assert km.grad_round(k, 4000, False, False) == (1, 4001)
        assert km.grad_round_tile(k, 1, 1, head=False,
                                  recompute=False)["floats"] == 57158
    cost = km.volume_backward_cost(40, 200, 24, k)
    assert cost["boxadd"] == 0 and cost["rsqrt"] > 0


def test_k8_strip_fits_every_k_it_took():
    """K8's block (``allpairs_smem_floats``): the strip's kApRows + k - 1
    camera and projector rows of the halo'd 16 x 64 tile (3,240 floats at
    k = 15, 48,384 at k = 129), or the block's 16,384 window sums where
    they take more.  Every odd k <= 129 fits 227 KB, as it did on the
    first version's one-row blocks, and so does every odd k <= 143; from
    k = 145 the block does not fit and the count refuses."""
    assert (km.AP_TILE_X, km.AP_TILE_Y) == (16, 64)
    assert 30 * (16 + 64 + 28) == 3240
    assert km.allpairs_block_floats(15) == 16 * 8 * 128 == 16384
    assert km.allpairs_block_floats(129) == 144 * (80 + 256) == 48384
    for k in range(3, 145, 2):
        assert km.allpairs_block_floats(k) <= LIMIT
    assert km.allpairs_block_floats(145) > LIMIT
    with pytest.raises(ValueError, match="K8 takes no k = 145"):
        km.allpairs_forward_cost(40, 200, 145)


def test_k8b_blocking_mirrors_the_source_and_fits():
    """K8b's blocking (``csrc/zncc_allpairs_bwd.cu``), mirrored in
    ``kernel_model``: 256 threads, 4 camera columns and 64 projector
    columns a chunk, strips of 16 rows summed by ``window_sweep``, E units
    of 8 taps, walks of at most 128 taps, and the banded VJPs' combine
    called as it is.  Its block fits every k (the taps of a walk are
    capped), four blocks an SM at the verify shape; the taps skip those
    that meet no projector column (k // 2 >= W)."""
    src = (CSRC / "zncc_allpairs_bwd.cu").read_text()
    assert tuple(_const(src, n) for n in (
        "kGbThreads", "kGbTileX", "kGbRows", "kGbTaps", "kGbTapChunk")) == (
            km.GB_THREADS, km.GB_TILE_X, km.GB_ROWS, km.GB_TAPS,
            km.GB_TAP_CHUNK)
    assert "constexpr int kGbChunkW = kGbThreads / kGbTileX;" in src
    assert "constexpr int kGbSplits = kGbChunkW / 32;" in src
    assert (km.GB_CHUNK_W, km.GB_PAIRS, km.GB_SPLITS) == (64, 64, 2)
    assert "window_sweep(\n          acc, k," in src
    assert "return launch_grad_combine(camera, cam_s, a1, bm, grmu, grad" \
        in src
    assert '#include "camera_grad.cuh"' in src
    assert km.allpairs_grad_block_floats(422, 15) == (
        2 * 64 * 65 + 16 * (81 + 64) + 2 * 64 * (2 + 2 * 8))
    assert 4 * (4 * km.allpairs_grad_block_floats(422, 15) + 1024) <= (
        228 * 1024)
    for W, k in ((422, 145), (422, 255), (1242, 1001), (5, 13), (3, 1)):
        assert km.allpairs_grad_block_floats(W, k) <= LIMIT
    assert km.allpairs_grad_taps(422, 15) == (0, 15)
    assert km.allpairs_grad_taps(422, 1) == (0, 1)
    assert km.allpairs_grad_taps(5, 13) == (2, 9)
    assert km.allpairs_grad_taps(6, 31) == (10, 11)


@pytest.mark.parametrize("shape, want, bytes_rw", [
    ((24, 60, 5), {"madd": 944960, "smem": 720384, "exp": 0,
                   "rsqrt": 259200}, (34560, 368640)),
    ((330, 422, 15), {"madd": 1158063840, "smem": 902576592, "exp": 0,
                      "rsqrt": 176303160}, (3342240, 237299040))])
def test_counts_of_k8(shape, want, bytes_rw):
    """K8's counts, pinned: the rows' products in ``smem`` (their loads
    bind over their FMAs) and the sums' trip through shared memory, k adds
    an output and the normalisation in ``madd`` and ``rsqrt``, no
    ``boxadd``; the [H, W, W] volume written once."""
    cost = km.allpairs_forward_cost(*shape)
    assert {m: cost[m] for m in want} == want and cost["boxadd"] == 0
    assert (int(cost.bytes_r), int(cost.bytes_w)) == bytes_rw
    h, w, _ = shape
    assert cost.bytes_w >= 4 * h * w * w


def _stats_floats(k: int) -> int:
    """The statistics kernel's block (``box_stats_kernel`` of common.cuh):
    the halo'd tile and its two rows passes."""
    p = k // 2
    return (16 + 2 * p) * (64 + 2 * p) + 2 * 16 * (64 + 2 * p)


@pytest.mark.parametrize("k", list(range(3, 129, 2)))
def test_k4_k5_k6_and_k7_take_every_k_at_every_d(k):
    """K4, K5, K6 and K7 take every odd k <= 127 at every D, as K1, K2 and
    K3 do and as their JAX kernels do: each launch of the route the
    mirrored geometry picks has at least one plane a round (a power of two
    up to kGradPlanes) and a block that fits 227 KB.  K4 stages its
    constants up to k = 47 and reads them from their maps beyond; K5 runs
    its halo kernel up to k = 27 and K6 its recomputing block up to
    k = 81, and beyond each takes the chunked route: for every slab of
    COST_CHUNK planes K1's rounds kernel and the rounds kernel reading the
    slab (K4's instantiation for K5, K2's for K6), the slab never the whole
    volume once D + 1 > COST_CHUNK; K7's combine takes its maps one at a
    time past k = 93."""
    def fits_rounds(d, head, recompute, staged=True):
        planes, chunk = km.grad_round(k, d, head, recompute, staged)
        assert 1 <= planes <= km.GRAD_PLANES and planes & (planes - 1) == 0
        assert planes == 1 or planes <= d + 1
        assert 1 <= chunk <= d + 1
        assert km.grad_round_tile(k, chunk, planes, head=head,
                                  recompute=recompute,
                                  staged=staged)["floats"] <= LIMIT

    def fits_slabs(d, head):
        for lo, hi in km.cost_slabs(d):
            assert 1 <= hi - lo + 1 <= km.COST_CHUNK
            assert km.fused_round(k, hi - lo)[0] >= 1
            assert km.fused_block_floats(k, hi - lo) <= LIMIT
            fits_rounds(hi - lo, head, False,
                        not head or km.k4_staged(k, km.COST_CHUNK - 1))
        assert [lo for lo, _ in km.cost_slabs(d)] == list(
            range(0, d + 1, km.COST_CHUNK))

    assert _stats_floats(k) <= LIMIT
    assert min(_k7_combine_floats(k, 3), _k7_combine_floats(k, 1)) <= LIMIT
    for d in (0, 1, 192, 1800, 4000):
        # K4.
        fits_rounds(d, True, False, km.k4_staged(k, d))
        assert km.k4_staged(k, d) == (k <= 47)
        # K5.
        if km.halo_fits(k, d):
            planes, chunk = km.halo_round(k, d)
            assert km.halo_tile(k, chunk, planes)["floats"] <= LIMIT
            assert km.cost_slab_planes("K5", k, d) == 0
        else:
            fits_slabs(d, True)
            assert km.cost_slab_planes("K5", k, d) == min(km.COST_CHUNK,
                                                          d + 1)
        assert km.halo_fits(k, d) == (k <= 27)
        # K6.
        if km.grad_round(k, d, False, True)[0] >= 1:
            fits_rounds(d, False, True)
            assert km.cost_slab_planes("K6", k, d) == 0
        else:
            fits_slabs(d, False)
            assert km.cost_slab_planes("K6", k, d) == min(km.COST_CHUNK,
                                                          d + 1)
        assert (km.cost_slab_planes("K6", k, d) > 0) == (k > 81)
        # K7.
        fits_rounds(d, False, False)


@pytest.mark.parametrize("fn, shape, want", [
    ("fused_backward_c_cost", (40, 130, 24, 49), PIN_K4_K49),
    ("fused_backward_c_cost", (H, W, D, 127), PIN_K4_K127),
    ("fused_backward_cost", (40, 130, 24, 29), PIN_K5_K29),
    ("fused_backward_cost", (H, W, D, 127), PIN_K5_K127),
    ("k6_cost", (40, 130, 24, 83), PIN_K6_K83),
    ("k6_cost", (H, W, D, 127), PIN_K6_K127),
    ("projector_backward_cost", (40, 130, 24, 95), PIN_K7_K95),
    ("projector_backward_cost", (H, W, D, 127), PIN_K7_K127)])
def test_counts_past_the_old_limits(fn, shape, want):
    """The counts of K4's, K5's, K6's and K7's routes past their old
    limits, pinned, so each such launch has a model: no ``boxadd``; K5's
    and K6's chunked route write the slabs once (one volume in all) and
    read them back as K4 and K2 read a volume."""
    cost = (km.volume_backward_cost(*shape, with_cost=False)
            if fn == "k6_cost" else getattr(km, fn)(*shape))
    assert {m: cost[m] for m in want} == want and cost["boxadd"] == 0
    h, w, d, k = shape
    volume = 4 * (d + 1) * h * w
    chunked = fn in ("fused_backward_cost", "k6_cost")
    assert (cost.bytes_w > volume) == chunked
    assert cost.bytes_r > (volume if fn != "fused_backward_cost" else 0)


def _box_walk(k: int, span: int = km.LK_BOX_SPAN):
    """The line entries each output of a ``box_axis`` block adds, in the
    order it adds them: for every group of the block (``first`` = g
    kBoxOut), the chunks of ``span`` staged entries in turn, each
    ``box_entries``' range of the group's entries (``window_sweep`` for a
    whole line, else the predicated loop); entry i of a group is staged
    entry first + i.  Returns {(group, output): [staged entries]} and the
    most entries a chunk staged."""
    n_out, tile = km.LK_BOX_OUT, km.LK_BOX_TILE
    total = tile + k - 1
    taps, most = {}, 0
    for g in range(km.LK_BOX_GROUPS):
        first = g * n_out
        out = [[] for _ in range(n_out)]
        for s0 in range(0, total, span):
            rows = min(span, total - s0)
            most = max(most, rows)
            i0, i1 = max(s0 - first, 0), min(s0 + rows - first, n_out - 1 + k)
            if i0 >= i1:
                continue
            if i0 == 0 and i1 == n_out - 1 + k:
                for n, t in enumerate(_tap_order(n_out, k)):
                    out[n] += [first + i for i in t]
                continue
            for i in range(i0, i1):
                assert 0 <= first + i - s0 < rows
                for n in range(n_out):
                    if 0 <= i - n < k:
                        out[n].append(first + i)
        for n in range(n_out):
            taps[g, n] = out[n]
    return taps, most


@pytest.mark.parametrize("k, span", [
    (3, km.LK_BOX_SPAN), (129, km.LK_BOX_SPAN), (255, km.LK_BOX_SPAN),
    (257, km.LK_BOX_SPAN), (641, km.LK_BOX_SPAN), (129, 143), (15, 23),
    (31, 40)])
def test_large_k_box_adds_each_output_taps_in_order(k, span):
    """``box_axis`` (csrc/large_k.cu): output m of a block's tile adds
    staged entries m, m + 1, ..., m + k - 1 in that order, the taps t =
    0..k-1 of the plain ``_box_axis``, whether its line is staged whole
    (every k <= 256) or in chunks (a larger k, or a smaller span), and no
    chunk stages more than ``span`` entries of a line."""
    taps, most = _box_walk(k, span)
    for (g, n), t in taps.items():
        m = g * km.LK_BOX_OUT + n
        assert t == list(range(m, m + k))
    assert most <= span


def test_large_k_box_stages_every_k_it_takes_in_one_chunk():
    """The model's staged loads of a ``box_axis`` item: kBoxOut + k - 1
    entries for kBoxOut outputs, each entry once, from one chunk of at most
    ``LK_BOX_SPAN`` entries a line for every odd k from 129 (the route's
    first) to 255; a block's 32 lines of it fit the 48 KB of static shared
    memory; k = 257 takes two chunks."""
    for k in range(129, 256, 2):
        assert km.lk_box_chunks(k) == 1
        assert km.LK_BOX_TILE + k - 1 <= km.LK_BOX_SPAN
        access = km.LK_BOX_OUT + k - 1 + km.LK_BOX_OUT
        c = km.window_pass_cost(1, km.LK_BOX_OUT, k, False)
        # The adds bind: k an output, the loads and stores beside them.
        assert access * km.FMA_PER_SMEM < km.LK_BOX_OUT * k
        assert c["madd"] == km.LK_BOX_OUT * k and c["smem"] == 0
        taps, _ = _box_walk(k)
        reads = sorted(e for t in taps.values() for e in t)
        assert set(reads) == set(range(km.LK_BOX_TILE + k - 1))
    assert km.lk_box_chunks(257) == 2
    assert 32 * km.LK_BOX_SPAN * 4 <= 48 * 1024


def test_large_k_window_constants_mirror_the_source():
    """``kernel_model``'s mirrors of csrc/large_k.cu's window-sum blocking
    (``box_axis``: outputs a thread, groups, staged span; ``row_products``:
    warps, a thread's x and y, taps a chunk), the kernels staging in
    shared memory and summing with ``window_sweep``, and no grid-stride
    loop left in either."""
    src = (CSRC / "large_k.cu").read_text()
    assert tuple(_const(src, n) for n in ("kBoxOut", "kBoxGroups")) == (
        km.LK_BOX_OUT, km.LK_BOX_GROUPS)
    span = re.search(r"constexpr int kBoxSpan = kBoxTile \+ (\d+);", src)
    assert km.LK_BOX_TILE + int(span[1]) == km.LK_BOX_SPAN
    assert km.LK_BOX_SPAN % 2 == 1
    assert "constexpr int kBoxTile = kBoxOut * kBoxGroups;" in src
    assert tuple(_const(src, n) for n in (
        "kRpWarps", "kRpXPer", "kRpYPer", "kRpTaps")) == (
            km.LK_RP_WARPS, km.LK_RP_X_PER, km.LK_RP_Y_PER, km.LK_RP_TAPS)
    assert "__shared__ float buf[kBoxSpan * 32];" in src
    assert "__shared__ float cs[kRpTileX + kRpTaps - 1];" in src
    assert "custereo::window_sweep(acc, k, load, add);" in src
    assert '#include "common.cuh"' in src
    for name in ("box_axis_h_kernel", "box_axis_w_kernel",
                 "row_products_kernel"):
        body = src[src.index(f"    {name}("):]
        body = body[:body.index("\n}\n")]
        assert "GRID_STRIDE" not in body and "__shared__" in body
