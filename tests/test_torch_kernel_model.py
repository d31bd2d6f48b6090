"""PyTorch port: the bound model (``utils/kernel_model.py``), its rate
probes' plain versions (K10a-c) and ``utils/profiling.py``, held against
the JAX package where it has a counterpart: K10a's twin against
``_rate_kernel`` in interpret mode, ``OpCount`` against JAX's on the
shared classes, ``zncc_roofline`` against JAX's on one spec.  The
probes themselves need the card (``chip_smoke.py``)."""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from custereomatching_tpu.utils import kernel_model as jkm
from custereomatching_tpu_torch.scripts import device_probe
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils import profiling

CSRC = Path(km.__file__).resolve().parents[1] / "csrc"
H, W, D, K = 375, 1242, 192, 15
CARD = "NVIDIA H100 80GB HBM3"
RATES = {"madd": 0.03e-12, "smem": 0.12e-12, "exp": 0.3e-12,
         "rsqrt": 0.25e-12, "boxadd": 0.27e-12}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")


@pytest.mark.parametrize("mode, jax_mode", [
    ("madd", "madd"), ("exp", "exp"), ("rsqrt", "rsqrt"),
    ("smem", "lshift"), ("smem", "sshift"), ("boxadd", "boxadd")])
def test_rate_probe_twin_matches_jax_rate_kernel(mode, jax_mode):
    """12 iterations (inner 4, grid 3) of an 8 x 128 tile; the port's smem
    is the counterpart of both TPU shifts (a neighbour read of 0.015625)
    and its boxadd adds the same window sum, 225 * 0.015625."""
    want = np.asarray(jkm._rate_call(jax_mode, 4, 8, 128, 3, 1, True)())
    got = km.rate_probe_reference(mode, 12, 8, 128)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["madd", "smem", "exp", "rsqrt", "boxadd"])
def test_rate_probe_on_the_cpu_is_the_plain_version(mode):
    before = profiling.COUNTS.copy()
    got = km.rate_probe(mode, 16, 2, "cpu")
    assert profiling.COUNTS - before == Counter(
        {"plain.rate_probe_reference": 1})
    assert got.shape == (2, km.rate_probe_cols(mode))
    assert torch.equal(got, km.rate_probe_reference(
        mode, 16, 2, km.rate_probe_cols(mode)))
    assert bool((got == got[0, 0]).all())   # every chain holds one value


def _round_f32(x):
    """The fp32 value nearest the rational ``x`` (ties to even)."""
    from fractions import Fraction

    c = np.float32(float(x))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(v.view(np.int32)) & 1))


def test_madd_twin_rounds_once_as_fmaf():
    """K10a's madd is fmaf(a, 0.9996f, 0.00025f): exact product and sum,
    one rounding.  Near the fixed point the chain stalls where a step
    moves it by less than half an ulp, so at the measuring launch's
    iterations only a once-rounded twin lands on the kernel's value; the
    product rounded first stalls elsewhere, ~1e-4 away."""
    from fractions import Fraction

    iters = km.RATE_ITERS["madd"]
    mul, add = np.float32(0.9996), np.float32(0.00025)
    fma = two = np.float32(0.6)
    for _ in range(iters):
        fma = _round_f32(Fraction(float(fma)) * Fraction(float(mul))
                         + Fraction(float(add)))
        two = np.float32(np.float32(two * mul) + add)
    got = km.rate_probe_reference("madd", iters, 1, 1)
    assert got.item() == float(fma)
    assert abs(float(fma) - 0.625) < 1e-4
    assert float(two) != float(fma)


def test_rate_probe_checks_its_arguments():
    with pytest.raises(ValueError, match="unknown"):
        km.rate_probe("lshift", 8, 1, "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        km.rate_probe("madd", 12, 1, "cpu")


def test_hbm_probe_twins_against_numpy():
    rng = np.random.default_rng(0)
    vol = rng.random((7, 5, 9), dtype=np.float32)
    want = np.zeros((5, 9), np.float32)
    for plane in vol:
        want = want + plane
    before = profiling.COUNTS.copy()
    got = km.hbm_read_probe(torch.from_numpy(vol))
    assert profiling.COUNTS - before == Counter(
        {"plain.hbm_read_reference": 1})
    np.testing.assert_array_equal(got.numpy(), want)
    out = km.hbm_write_probe(4, 3, 5, "cpu")
    np.testing.assert_array_equal(
        out.numpy(), np.broadcast_to(np.arange(4, dtype=np.float32)
                                     [:, None, None], (4, 3, 5)))
    with pytest.raises(ValueError, match="float32"):
        km.hbm_read_probe(torch.zeros(2, 3, 4, dtype=torch.float64))


@pytest.mark.parametrize("shape", km.HBM_EDGE_SHAPES + ((3, 1, 1),))
def test_hbm_probe_twins_at_ragged_shapes(shape):
    """The contract the kernels are held to on the card, at shapes whose
    rows and planes lie off 16-byte boundaries and whose counts are not a
    multiple of 4: K10b's plain version adds each pixel's planes in plane
    order (a numpy loop in that order, bit for bit, also from a volume 4
    bytes off a boundary), K10c's is exact."""
    P, H, W = shape
    rng = np.random.default_rng(P)
    flat = rng.random(P * H * W + 1, dtype=np.float32)
    for off in (0, 1):
        vol = flat[off:off + P * H * W].reshape(P, H, W)
        want = np.zeros((H, W), np.float32)
        for d in range(P):
            want = want + vol[d]
        got = km.hbm_read_probe(torch.from_numpy(flat)[off:off + P * H * W]
                                .view(P, H, W))
        np.testing.assert_array_equal(got.numpy(), want)
    out = km.hbm_write_probe(P, H, W, "cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    for d in range(P):
        assert bool((out[d] == d).all())


def test_hbm_probes_check_their_arguments():
    """The wrappers refuse what the kernels do not take, before any
    launch: K10b a volume that is not fp32, not 3-D or empty, or on a
    device that is neither CUDA nor the CPU; K10c an empty shape or such a
    device."""
    for bad in (torch.zeros(2, 3), torch.zeros(2, 3, 4, 5),
                torch.zeros(0, 3, 4), torch.zeros(2, 3, 4,
                                                  dtype=torch.float16)):
        with pytest.raises(ValueError, match="non-empty float32"):
            km.hbm_read_probe(bad)
    with pytest.raises(ValueError, match="CUDA or"):
        km.hbm_read_probe(torch.zeros(2, 3, 4, device="meta"))
    for P, H, W in ((0, 3, 4), (2, 0, 4), (2, 3, -1)):
        with pytest.raises(ValueError, match="non-empty"):
            km.hbm_write_probe(P, H, W, "cpu")
    with pytest.raises(ValueError, match="CUDA or"):
        km.hbm_write_probe(2, 3, 4, "meta")
    before = profiling.COUNTS.copy()
    km.hbm_read_probe(torch.ones(2, 3, 4))
    km.hbm_write_probe(2, 3, 4, "cpu")
    assert profiling.COUNTS - before == Counter(
        {"plain.hbm_read_reference": 1, "plain.hbm_write_reference": 1})


def test_probe_constants_mirror_the_sources():
    """Pricing reads the kernels' geometry from Python mirrors: they must
    be the sources' constants."""
    common = (CSRC / "common.cuh").read_text()
    probes = (CSRC / "rate_probes.cu").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (const(common, "kTileH"), const(common, "kTileW")) == (
        km.K_TILE_H, km.K_TILE_W)
    assert (const(probes, "kRateThreads"), const(probes, "kChains"),
            const(probes, "kUnroll")) == (km.RATE_THREADS, km.RATE_CHAINS,
                                          km.RATE_UNROLL)
    assert (const(probes, "kBoxK"), const(probes, "kBoxD")) == (
        km.BOX_PROBE_K, km.BOX_PROBE_D)


def test_boxadd_is_normalised_by_the_pricing_count():
    """One boxadd pass of the probe is K1's per-plane pass of one block:
    16 x 78 entries of 15 product taps (two loads each), then 15 column
    taps for each of 1024 pixels."""
    per_pass = km.box_pass_loads(15, 16, 78, 1024)
    assert per_pass == 16 * 78 * 15 * 2 + 1024 * 15 == 52800
    assert km.rate_probe_elems("boxadd", 3, 5) == 15 * per_pass
    assert km.rate_probe_elems("madd", 3, 8) == 3 * 256 * 8 * 8


def test_opcount_algebra_and_time_match_jax():
    a, ja = km.OpCount(madd=10, exp=3), jkm.OpCount(madd=10, exp=3)
    b, jb = km.OpCount(rsqrt=5, boxadd=7), jkm.OpCount(rsqrt=5, boxadd=7)
    for x in (a, ja):
        x.bytes_r, x.bytes_w, x.bytes = 100.0, 10.0, 110.0
    for x in (b, jb):
        x.bytes_r, x.bytes_w, x.bytes = 50.0, 5.0, 55.0
    c, jc = (a + b).scaled(2), (ja + jb).scaled(2)
    assert c.bytes_r == 300.0 and c.bytes_w == 30.0 and c.bytes == 330.0
    assert c["madd"] == 20 and c["boxadd"] == 14 and c["smem"] == 0
    rates = dict(RATES, lshift=1e-12, sshift=1e-12, mxuhi=1e-12)
    dma = dict(rates, hbm_r3d=2.0e-12, hbm_w3d=4.0e-12)
    for r in (rates, dma):                      # data sheet, then HBM rates
        got, want = c.time(r, 3.35e12), jc.time(r, 3.35e12)
        for key in ("t_compute_s", "t_memory_s", "bound_s", "bound_by"):
            assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert c.time(dma, 3.35e12)["t_memory_s"] == pytest.approx(
        300.0 * 2.0e-12 + 30.0 * 4.0e-12)
    assert c.time(rates, 3.35e12)["t_memory_s"] == pytest.approx(
        330.0 / 3.35e12)
    assert set(c.time(rates, 1.0)["by_class"]) == {"madd", "exp", "rsqrt",
                                                  "boxadd"}
    out = km.kernel_bound(c, rates, hbm_bw=3.35e12)
    assert out["bound_fps"] == pytest.approx(1.0 / out["bound_s"])


def _write_cache(path, entries):
    path.write_text(json.dumps(entries))
    return str(path)


def test_rates_cache_branches(tmp_path):
    """After tests/test_kernel_model.py:124-141, by card name: a partial
    (compute-only) cache is returned as is when measuring is off, a card
    the cache lacks gives None, a full cache (its HBM rates beside the
    probes' design) is returned without measuring, and the recorded power
    limit and design are not rates."""
    partial = _write_cache(tmp_path / "partial.json",
                           {CARD: dict(RATES, power_limit="700.00 W")})
    got = km.measure_vpu_rates(cache_path=partial, measure_if_missing=False,
                               device_name=CARD)
    assert got == {m: pytest.approx(v) for m, v in RATES.items()}
    assert km.measure_vpu_rates(cache_path=partial,
                                measure_if_missing=False,
                                device_name="another card") is None
    full = dict(RATES, hbm_r3d=3e-13, hbm_w3d=3e-13, t3d=1e-12,
                dus3d=1e-12)
    path = _write_cache(tmp_path / "full.json",
                        {CARD: dict(full, power_limit="700.00 W",
                                    hbm_probe=km.HBM_PROBE)})
    assert km.measure_vpu_rates(cache_path=path, device_name=CARD) == full


@pytest.mark.parametrize("tag", [None, "thread a pixel, planes in turn"])
def test_rates_cache_drops_hbm_rates_of_other_probes(tmp_path, tag):
    """HBM rates cached without the probes' design, or beside another,
    were measured by other probes: they price nothing (the memory leg
    falls back to the data sheet) and count as missing, so a call that may
    measure measures them again; beside this design they are used."""
    full = dict(RATES, hbm_r3d=3e-13, hbm_w3d=4e-13, t3d=1e-12,
                dus3d=1e-12)
    entry = dict(full, power_limit="700.00 W")
    if tag is not None:
        entry["hbm_probe"] = tag
    old = _write_cache(tmp_path / "old.json", {CARD: entry})
    got = km.measure_vpu_rates(cache_path=old, measure_if_missing=False,
                               device_name=CARD)
    assert got == {m: v for m, v in full.items()
                   if m not in ("hbm_r3d", "hbm_w3d")}
    vol = km.hbm_write_probe_cost(*km.HBM_SHAPE)
    assert vol.time(got, 3.35e12)["t_memory_s"] == pytest.approx(
        vol.bytes / 3.35e12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            km.measure_vpu_rates(cache_path=old, device_name=CARD)
    new = _write_cache(tmp_path / "new.json",
                       {CARD: dict(entry, hbm_probe=km.HBM_PROBE)})
    assert km.measure_vpu_rates(cache_path=new, measure_if_missing=False,
                                device_name=CARD) == full
    assert km.measure_vpu_rates(cache_path=new, device_name=CARD) == full


def test_measuring_needs_a_card(tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match="none is available"):
        km.measure_vpu_rates()
    partial = _write_cache(tmp_path / "partial.json", {CARD: dict(RATES)})
    with pytest.raises(RuntimeError, match="none is available"):
        km.measure_vpu_rates(cache_path=partial, device_name=CARD)
    with pytest.raises(RuntimeError, match="none is available"):
        km.measure_vpu_rates(force=True, cache_path=partial,
                             device_name=CARD)
    with pytest.raises(RuntimeError, match="none is available"):
        km._run_dma_rate("hbm_r3d")
    assert device_probe.main([]) == 1


def _compute(cost):
    return cost.time(RATES, 3.35e12)["t_compute_s"]


def test_costs_scale_with_d_and_order_the_variants():
    base = km.fused_forward_cost(H, W, D, K)
    assert 1.7 < _compute(km.fused_forward_cost(H, W, 2 * D, K)) \
        / _compute(base) < 2.3
    assert 1.7 < _compute(km.volume_backward_cost(H, W, 2 * D, K)) \
        / _compute(km.volume_backward_cost(H, W, D, K)) < 2.3
    assert 1.7 < _compute(km.fused_backward_cost(H, W, 2 * D, K)) \
        / _compute(km.fused_backward_cost(H, W, D, K)) < 2.3
    # K2 and K6 run the same rounds kernel; K6 also recomputes the cost's
    # cross term, so it costs more.
    k2 = _compute(km.volume_backward_cost(H, W, D, K))
    k6 = _compute(km.volume_backward_cost(H, W, D, K, with_cost=False))
    assert k2 < k6
    k3w = km.fused_forward_cost(H, W, D, K, write_volume=True)
    k3m = km.fused_forward_cost(H, W, D, K, residuals=True)
    assert k3w.bytes > k3m.bytes > base.bytes
    assert k3w.bytes_w - k3m.bytes_w == 4 * (D + 1) * H * W
    # The register-blocked pass: K1 is K3's rounds without the head, so it
    # costs less than K3; K4 is K5's round without the halo's cost
    # recompute, so it costs less than K5, and so does K6, recomputing the
    # cost on the tile's own pixels only; K7 reads g and the cost on the
    # same rounds as K2, at columns shifted by d.
    k1 = km.volume_forward_cost(H, W, D, K)
    assert _compute(k1) < _compute(base)
    assert k1["smem"] == base["smem"] and k1["exp"] == 0
    k4 = _compute(km.fused_backward_c_cost(H, W, D, K))
    k5 = _compute(km.fused_backward_cost(H, W, D, K))
    assert k4 < k5 and k6 < k5
    assert _compute(km.projector_backward_cost(H, W, D, K)) < k6
    # No kernel runs K1's first pass any more: boxadd prices only K10a.
    for cost in (base, k1, km.fused_backward_cost(H, W, D, K),
                 km.fused_backward_c_cost(H, W, D, K),
                 km.volume_backward_cost(H, W, D, K),
                 km.volume_backward_cost(H, W, D, K, with_cost=False),
                 km.projector_backward_cost(H, W, D, K),
                 km.allpairs_forward_cost(330, 422, 15)):
        assert cost["boxadd"] == 0


def test_cost_fns_populate_byte_pools():
    costs = [
        km.volume_forward_cost(H, W, D, K),
        km.fused_forward_cost(H, W, D, K),
        km.fused_forward_cost(H, W, D, K, write_volume=True),
        km.volume_backward_cost(H, W, D, K),
        km.volume_backward_cost(H, W, D, K, with_cost=False),
        km.fused_backward_c_cost(H, W, D, K),
        km.fused_backward_cost(H, W, D, K),
        km.projector_backward_cost(H, W, D, K),
        km.allpairs_forward_cost(330, 422, 15),
    ]
    for c in costs:
        assert c.bytes_r > 0 and c.bytes_w > 0
        assert c.bytes == pytest.approx(c.bytes_r + c.bytes_w)
        assert all(v >= 0 for v in c.values())
    # The volume a kernel writes or reads is in its pools, once.
    vol = 4 * (D + 1) * H * W
    assert vol < costs[0].bytes_w < 1.1 * vol
    assert 2 * vol < costs[3].bytes_r < 2.1 * vol
    assert costs[6].bytes_r < 0.1 * vol
    # The all-pairs VJP floor's traffic has no read/write split: priced at
    # the data sheet's bandwidth.  K9's tiled transpose reads and writes
    # the volume once each, at the probes' bulk rates.
    plain = km.allpairs_backward_cost(330, 422, 15)
    assert plain.bytes > 0 and plain.bytes_r == 0
    k9 = km.transpose_volume_cost(H, W, D)
    assert k9.bytes == 2 * vol and k9.bytes_r == k9.bytes_w == vol
    hbm = dict(RATES, hbm_r3d=1e-12, hbm_w3d=2e-12)
    assert k9.time(hbm, 3.35e12)["t_memory_s"] == pytest.approx(
        vol * 1e-12 + vol * 2e-12)
    assert k9.time(RATES, 3.35e12)["t_memory_s"] == pytest.approx(
        2 * vol / 3.35e12)


def test_k9a_cost_counts_its_own_design():
    """K9a's count (``to_parity_cost``, the pixel-run kernel of
    csrc/layout.cu) moves the bytes K9a always moved, each element read
    and written once (at ``hbm_r3d`` and ``hbm_w3d``, as every volume),
    and counts its shared store and load an element; K9b's count
    (``transpose_volume_cost``, the tiled transpose it keeps) is the
    same."""
    n = (D + 1) * H * W
    k9a, k9b = km.to_parity_cost(H, W, D), km.transpose_volume_cost(H, W, D)
    assert k9a.bytes == k9b.bytes == 2.0 * n * 4
    assert k9a.bytes_r == k9a.bytes_w == n * 4
    assert k9a["smem"] == 2 * n and sum(k9a.values()) == 2 * n
    assert dict(k9b) == dict(km.OpCount(smem=2 * n))
    assert k9b.bytes_r == k9b.bytes_w == n * 4
    t = k9a.time(RATES, 3.35e12)
    assert t["bound_by"] == "memory"
    assert round(1e3 * t["t_memory_s"], 4) == 0.2147


def test_recompute_chunk_mirrors_camera_grad():
    """K6 at k=15 stages all D+1 planes at once up to D = 734 and in
    chunks beyond, a multiple of its 8 planes a round (camera_grad.cuh
    grad_round); K5 (fused_pipeline_bwd.cu) takes rounds of 5 planes and
    chunks of 125 at KITTI, one plane a round and chunks of 50 at k=27,
    and no block at k=29."""
    assert km.grad_round(15, 734, False, True) == (8, 735)
    assert km.grad_round(15, 735, False, True) == (8, 728)
    assert km.grad_round(15, 1600, False, True) == (8, 728)
    assert km.grad_round(15, 192, False, True) == (8, 193)
    assert km.grad_round(15, 3, False, True) == (4, 4)
    assert km.halo_round(15, 192) == (5, 125)
    assert km.halo_round(15, 600) == (5, 125)
    assert km.halo_round(15, 3) == (4, 4)
    assert km.halo_round(27, 64) == (1, 50)
    assert km.halo_round(29, 10) == (0, 0)


def test_k1_k3_round_mirrors_common():
    """K1 and K3 (common.cuh fused_round) at k=15 take 13 planes a round
    and stage the projector's D + 1 planes at once up to D = 782, in
    chunks of 780 (60 rounds) beyond; one plane a round at D = 0; at
    k = 127 one plane a round and a one-plane chunk, and no block at k =
    129, where the count refuses."""
    assert km.fused_round(15, 192) == (13, 193)
    assert km.fused_round(15, 782) == (13, 783)
    assert km.fused_round(15, 783) == (13, 780)
    assert km.fused_round(15, 1800) == (13, 780)
    assert km.fused_round(15, 0) == (1, 1)
    assert km.fused_round(5, 10) == (11, 11)
    assert km.fused_round(127, 4000) == (1, 1)
    assert km.fused_round(129, 0) == (0, 0)
    with pytest.raises(ValueError, match="K1 takes no k = 129"):
        km.volume_forward_cost(40, 200, 8, 129)
    with pytest.raises(ValueError, match="K7 takes no k = 129"):
        km.projector_backward_cost(40, 200, 8, 129)
    # Chunked stagings cost one projector tile each.
    one = km.volume_forward_cost(32, 800, 782, 15)
    two = km.volume_forward_cost(32, 800, 783, 15)
    assert two["smem"] - one["smem"] > 2 * 30 * (78 + 779) * 13 * 2


def test_zncc_roofline_matches_jax(monkeypatch):
    from custereomatching_tpu.utils import profiling as jprof

    monkeypatch.setattr(jprof, "device_specs", lambda device=None: {
        "hbm_bw": 3.35e12, "vpu_f32": 67e12})
    spec = {"hbm_bw": 3.35e12, "fp32_flops": 67e12}
    for materialize in (True, False):
        got = profiling.zncc_roofline(H, W, D, K,
                                      materialize_volume=materialize,
                                      spec=spec)
        want = jprof.zncc_roofline(H, W, D, K,
                                   materialize_volume=materialize)
        assert got == pytest.approx(want)


def test_device_specs_refuses_an_unknown_card():
    assert profiling.device_specs(name=CARD) == {"hbm_bw": 3.35e12,
                                                 "fp32_flops": 67e12}
    with pytest.raises(ValueError, match="A100"):
        profiling.device_specs(name="NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="cpu"):
        profiling.device_specs("cpu")


@pytest.mark.parametrize("kernel, ms, by", [
    ("K1", 0.1084, "bytes"), ("K3", 0.0590, "operations"),
    ("K3m", 0.0590, "operations"), ("K3w", 0.1123, "bytes"),
    ("K2", 0.2163, "bytes"), ("K7", 0.2163, "bytes"),
    ("K6", 0.1090, "bytes"), ("K4", 0.1129, "bytes"),
    ("K5", 0.1140, "operations"), ("K9a", 0.2147, "bytes"),
    ("K9b", 0.2147, "bytes")])
def test_least_work_bounds_keep_their_kitti_values(kernel, ms, by):
    got_ms, got_by = profiling.banded_bounds(1, H, W, D, K)[kernel]
    assert round(got_ms, 4) == ms and got_by == by


def test_k8b_count_reads_the_volumes_of_the_vjp_floor():
    """K8b's count (``allpairs_grad_cost``) at the verify shape, 330 x 422
    and k = 15, against the all-pairs VJP's mandatory traffic
    (``allpairs_backward_cost``): it reads the cotangent and the cost once
    each, as the floor does, and beside them moves only [H, W]-sized maps
    and E's [H, W, 15] buffer, written and read back once (4.7% more
    bytes); its work holds an rsqrt and k window adds an entry at least."""
    H, W, k = 330, 422, 15
    n, px = H * W * W, H * W
    floor = km.allpairs_backward_cost(H, W, k)
    cost = km.allpairs_grad_cost(H, W, k)
    assert floor.bytes == 4 * (2 * n + 3 * px)
    assert cost.bytes_r >= 8 * n and cost.bytes_w == 4 * px * (k + 4)
    assert cost.bytes == cost.bytes_r + cost.bytes_w
    assert floor.bytes < cost.bytes < 1.05 * floor.bytes
    assert cost.bytes - 8 * n == 4 * px * (2 * k + 13)
    assert cost["rsqrt"] >= n and cost["madd"] >= k * n
    assert cost["boxadd"] == 0 and cost["exp"] == 0
    # Priced at the data sheet's bandwidth, the floor is the issue's
    # 0.1408 ms; K8b's model is no faster.
    assert 1e3 * floor.bytes / 3.35e12 == pytest.approx(0.1408, abs=1e-4)
    assert (km.kernel_bound(cost, RATES, 3.35e12)["bound_s"]
            >= floor.bytes / 3.35e12)


def test_allpairs_least_work_bound():
    ms, by = profiling.allpairs_bound(1, 330, 422, 15)
    assert round(ms, 4) == 0.0705 and by == "bytes"
    assert profiling.bound(67e9, 0) == (pytest.approx(1.0), "operations")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in events and prof is not None


def test_sass_counts_reads_cuobjdump_output():
    sass = """
        Function : _ZN8custereo12_GLOBAL__N_115op_probe_kernelILi1EEEvPfifff
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS R3, [R2+0x4] ;
        /*0020*/                   FFMA R0, R0, 0.99959999322891235352, R3 ;
        /*0030*/              @!P0 BRA 0x10 ;
        Function : _ZN8custereo12_GLOBAL__N_116box_probe_kernelEPfiiifff
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/                   MUFU.RSQ R4, R4 ;
"""
    counts = device_probe.sass_counts(sass)
    op = counts["_ZN8custereo12_GLOBAL__N_115op_probe_kernelILi1EEEvPfifff"]
    assert (op["LDS"], op["FFMA"], op["BRA"]) == (1, 1, 1)
    box = counts["_ZN8custereo12_GLOBAL__N_116box_probe_kernelEPfiiifff"]
    assert (box["BAR"], box["MUFU"]) == (1, 1)


@pytest.mark.parametrize("module", [
    "custereomatching_tpu_torch.utils.kernel_model",
    "custereomatching_tpu_torch.scripts.device_probe",
    "custereomatching_tpu_torch.scripts.kernel_variants", "chip_smoke"])
def test_imports_no_jax(module):
    """The bound model, the health probe and the smoke script, which takes
    its least-work bounds from ``utils/profiling.py``, import no JAX."""
    code = (f"import sys, {module}; "
            f"print('jax' in sys.modules, 'custereomatching_tpu' in "
            f"sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(km.__file__).resolve().parents[2])
    assert out.stdout.split() == ["False", "False"]


def test_chip_smoke_shares_the_bounds_and_lists_every_kernel():
    import chip_smoke

    assert chip_smoke.banded_bounds is profiling.banded_bounds
    assert chip_smoke.allpairs_bound is profiling.allpairs_bound
    keys = [row[1] for row in chip_smoke.KERNELS]
    assert len(keys) == len(set(keys)) == 15
    assert {"K10a", "K10b", "K10c"} <= set(keys)
    for _, key, source, replaces, path in chip_smoke.KERNELS:
        assert chip_smoke.PATH_LAUNCHES[path][key] >= 1
        file, line = replaces.rsplit(":", 1)
        root = Path(km.__file__).resolve().parents[2]
        assert (root / source).is_file()
        text = (root / file).read_text().splitlines()
        assert text[int(line) - 1].startswith("def _")
