"""PyTorch port: the tile tuner (``custereomatching_tpu_torch/ops/tuning.py``)
and the tile it searches: the rounds kernels of K1, K3 (K3w, K3m) and K4
at tiles of 8, 16 and 32 rows (``csrc/common.cuh`` ``Tile``), mirrored by
``utils/kernel_model.py``.

The kernels and the measurement need the card (``chip_smoke.py`` tunes K1,
K3 and K4 at KITTI and K3 at serve's bucket there, every measured tile
bit-equal to the default).  Here, on the CPU: the derived candidates
against the mirrored shared memory and the large-k route, the model at the
default tile unchanged, the ranking, ``_tune``'s caches, key, gate and
failures with a stub build (and against the JAX package's ``_tune`` on the
same stub), the engine's per-bucket lazy tuning with the tuner stubbed
against the JAX package's maps, the config's card tile, and the wrappers'
refusal of a tile that does not fit."""

import dataclasses
import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models.stereo import StereoMatcher as JaxMatcher
from custereomatching_tpu.ops import tuning as jax_tuning
from custereomatching_tpu_torch.config import (
    DEFAULT_TILE,
    StereoConfig,
    config_from_jax,
)
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.models.engine import StereoEngine
from custereomatching_tpu_torch.ops import _build, cuda_zncc, tuning
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    stereo_pipeline_reference,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import (
    cost_volume_banded_cuda,
    own_blocks,
)
from custereomatching_tpu_torch.utils import kernel_model as km

KITTI = (375, 1242, 192, 15)
BUCKET = (384, 512, 48, 15)
LIMIT = km.SMEM_OPTIN_BYTES // 4
KINDS = ("pipeline", "volume", "trainable_bwd")
CSRC = Path(km.__file__).resolve().parents[1] / "csrc"


def _pair(seed, H, W, B=1):
    rng = np.random.default_rng(seed)
    return (rng.random((B, H, W), dtype=np.float32),
            rng.random((B, H, W), dtype=np.float32))


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [KITTI, BUCKET, (24, 40, 6, 5),
                                   (64, 128, 16, 9), (37, 200, 24, 31),
                                   (40, 130, 24, 127)])
@pytest.mark.parametrize("kind", KINDS)
def test_candidates_fit_and_lead_with_the_default(kind, shape):
    """Non-empty, the default tile first (16 rows at the kernel's own
    planes), every candidate's block within an H100's opt-in shared memory
    and off the large-k route at its tile, no tile taller than the image
    needs, no two candidates with the same rounds."""
    H, W, D, k = shape
    cands = tuning.candidate_blocks(kind, H, W, D, k)
    assert cands
    kernel = {"pipeline": "K3", "volume": "K1", "trainable_bwd": "K4"}[kind]
    if kind == "trainable_bwd":
        assert cands[0] == (16, km.grad_round(
            k, D, True, False, km.k4_staged(k, D))[0])
    else:
        assert cands[0] == (16, km.round_planes(k, D))
        assert km.fused_round(k, D, None, *cands[0]) == km.fused_round(k, D)
        rounds = [km.fused_round(k, D, None, *c) for c in cands]
        assert len(set(zip((c[0] for c in cands), rounds))) == len(cands)
    for rows, planes in cands:
        assert rows in km.TILE_ROWS and planes >= 1
        assert rows <= max(-(-H // 8) * 8, 16)
        assert not km.large_k_route(kernel, k, D, None, rows,
                                    0 if kind == "trainable_bwd" else planes)
        if kind == "trainable_bwd":
            staged = km.k4_staged(k, D, None, rows)
            P, chunk = km.grad_round(k, D, True, False, staged, None, rows)
            assert planes == P
            t = km.grad_round_tile(k, chunk, P, head=True, recompute=False,
                                   staged=staged, tile_rows=rows)
            assert t["floats"] <= LIMIT
        else:
            assert km.fused_block_floats(k, D, None, rows, planes) <= LIMIT


def test_candidates_at_kitti():
    """At KITTI (k = 15) K1 and K3 run at 8 and 16 rows (32 rows take the
    predicated rows pass), K4 at every tile; K3's lattice holds each
    tile's own planes, half, two and three times them (where they fit) and
    the most beside the whole projector staged once; the names the JAX
    module exports are the KITTI lattices."""
    cands = tuning.candidate_blocks("pipeline", *KITTI)
    assert cands == [(16, 13), (16, 6), (16, 20), (8, 7), (8, 3), (8, 14),
                     (8, 21)]
    assert tuning.candidate_blocks("volume", *KITTI) == cands
    assert tuning.PIPELINE_CANDIDATES == tuning.VOLUME_CANDIDATES == tuple(
        cands)
    assert tuning.candidate_blocks("trainable_bwd", *KITTI) == [
        (16, 8), (8, 8), (32, 8)]
    # A short image leaves the tall tile out (k = 31: not predicated).
    assert {r for r, _ in tuning.candidate_blocks("pipeline", 20, 128, 8,
                                                  31)} == {8, 16}
    assert {r for r, _ in tuning.candidate_blocks("pipeline", 40, 128, 8,
                                                  31)} == {8, 16, 32}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [3, 5, 7, 15, 29, 31, 47])
def test_candidates_leave_out_the_predicated_rows_pass(kind, k):
    """K1's and K3's rows pass makes a tile's rows a column
    (``window_taps<TH>``) and below k = TH - 1 takes the predicated loop,
    which the model does not price: those tiles are left out, except the
    default, which is always offered; K4's rows pass makes 8 rows at every
    tile, so its tiles stay."""
    rows = {r for r, _ in tuning.candidate_blocks(kind, 64, 256, 24, k)}
    assert 16 in rows
    if kind == "trainable_bwd":
        assert rows == set(km.TILE_ROWS)
    else:
        assert rows == {th for th in km.TILE_ROWS
                        if th == 16 or k >= th - 1}


@pytest.mark.parametrize("kind, k", [("pipeline", 131), ("volume", 133),
                                     ("trainable_bwd", 187)])
def test_candidates_empty_where_every_tile_takes_the_route(kind, k):
    """Where ``large_k_route`` holds at every tile the list is empty and
    the tuner returns the default (None) without measuring."""
    kernel = {"pipeline": "K3", "volume": "K1", "trainable_bwd": "K4"}[kind]
    assert all(km.large_k_route(kernel, k, 24, None, rows)
               for rows in km.TILE_ROWS)
    assert tuning.candidate_blocks(kind, 40, 130, 24, k) == []


def test_candidates_follow_the_tile_where_its_route_begins():
    """A tile moves where the large-k route begins: K3's own blocks end at
    k = 109 at 8 rows, 127 at 16 and 129 at 32; K4's at 175, 185, 185."""
    last = {kernel: [max(k for k in range(3, 300, 2)
                         if not km.large_k_route(kernel, k, 24, None, rows))
                     for rows in km.TILE_ROWS]
            for kernel in ("K1", "K3", "K4")}
    assert last == {"K1": [109, 127, 129], "K3": [109, 127, 129],
                    "K4": [175, 185, 185]}
    assert tuning.candidate_blocks("pipeline", 40, 130, 24, 129) == [
        (32, 1)]


def test_trainable_bwd_frees_only_the_rows():
    """K4's candidates vary the rows alone: the planes are the launcher's
    at each tile, never a lattice."""
    for shape in (KITTI, BUCKET, (40, 130, 24, 47)):
        cands = tuning.candidate_blocks("trainable_bwd", *shape)
        assert len({r for r, _ in cands}) == len(cands)


def test_candidate_kind_is_checked():
    with pytest.raises(ValueError, match="unknown kind"):
        tuning.candidate_blocks("stats", *KITTI)


# ---------------------------------------------------------------------------
# The bound model at a tile
# ---------------------------------------------------------------------------

def test_model_at_the_default_tile_is_unchanged():
    """The tile arguments default to today's tile: K1's, K3's and K4's
    counts at 16 rows (planes 0 or the kernel's own) are the defaults'."""
    H, W, D, k = KITTI
    own = km.round_planes(k, D)
    for tile in ((16, 0), (16, own)):
        assert km.volume_forward_cost(H, W, D, k, *tile) == \
            km.volume_forward_cost(H, W, D, k)
        for flags in ({}, {"write_volume": True}, {"residuals": True}):
            assert km.fused_forward_cost(
                H, W, D, k, tile_rows=tile[0], planes=tile[1], **flags) == \
                km.fused_forward_cost(H, W, D, k, **flags)
    assert km.fused_backward_c_cost(H, W, D, k, 16) == \
        km.fused_backward_c_cost(H, W, D, k)
    assert km.fused_round(k, D, None, 16, 0) == km.fused_round(k, D) == (
        13, 193)
    for kernel in km.LARGE_K_KERNELS:
        for kk in (15, 127, 129):
            assert km.large_k_route(kernel, kk, D) == km.large_k_route(
                kernel, kk, D, None, 16, 0)


def test_model_mirrors_the_tiles():
    """``fused_round`` at each tile (KITTI): 8 rows take 7 planes a round
    and stage the projector once; 32 rows want 21 and are left a 3-plane
    chunk, cut to rounds of 3; planes asked for are kept, refused where
    they do not fit, and cut to D + 1."""
    assert km.fused_round(15, 192, None, 8) == (7, 193)
    assert km.fused_round(15, 192, None, 32) == (3, 3)
    assert km.fused_round(15, 192, None, 32, 17) == (17, 193)
    assert km.fused_round(15, 192, None, 16, 20) == (20, 193)
    assert km.fused_round(15, 192, None, 16, 21) == (21, 168)
    assert km.fused_round(15, 192, None, 16, 24) == (0, 0)
    assert km.fused_round(15, 4, None, 16, 13) == (5, 5)
    assert km.tile_cols(8) == 128 and km.tile_cols(32) == 32
    with pytest.raises(ValueError, match="tile_rows"):
        km.tile_cols(24)
    with pytest.raises(ValueError, match="block of 16 rows and 24 planes"):
        km.volume_forward_cost(*KITTI, 16, 24)


def test_ranking_follows_the_model():
    """``_rank_candidates`` orders by the model's time at the given rates
    (ties in the given order); without rates it keeps the order."""
    H, W, D, k = KITTI
    rates = {m: 1e-12 for m in km._OP_MODES}
    rates.update(hbm_r3d=1 / 3.0e12, hbm_w3d=1 / 1.2e12)
    for kind in KINDS:
        cands = tuning.candidate_blocks(kind, H, W, D, k)
        ranked = tuning._rank_candidates(kind, cands, H, W, D, k, rates)
        assert sorted(ranked) == sorted(cands)
        ms = [tuning.model_ms(kind, c, H, W, D, k, rates) for c in ranked]
        assert ms == sorted(ms)
        assert tuning._rank_candidates(kind, cands, H, W, D, k, {}) == cands


# ---------------------------------------------------------------------------
# _tune
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """A fresh cache file, an empty in-process cache, a card name, a
    healthy probe and a stub clock: ``times`` (seconds a call by blocks)
    is what ``_slope_time`` reports for a built call, and ``timed`` lists
    what it reported, in order."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("CUSTEREO_TUNE_CACHE", str(path))
    monkeypatch.setattr(tuning, "_CACHE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(tuning, "_probe_health",
                        lambda: (True, 0.5e-12, 0.5e-12))
    times, timed = {}, []

    def clock(fn):
        timed.append(fn())
        return timed[-1]

    monkeypatch.setattr(tuning, "_slope_time", clock)

    def build(rows, planes):
        return lambda: times[(rows, planes)]

    return path, times, build, timed


def test_tune_caches_in_process_and_on_disk(tune_env):
    path, times, build, timed = tune_env
    times.update({(16, 13): 2e-3, (8, 7): 1e-3, (32, 10): 3e-3})
    cands = [(16, 13), (8, 7), (32, 10)]
    assert tuning._tune(("pipeline", 1), cands, build, 6) == (8, 7)
    assert timed == [2e-3, 1e-3, 3e-3]
    # In process: no second measurement.
    times.clear()
    assert tuning._tune(("pipeline", 1), cands, build, 6) == (8, 7)
    # A new process: the disk cache answers, keyed by schema and card.
    tuning._CACHE.clear()
    assert tuning._tune(("pipeline", 1), cands, build, 6) == (8, 7)
    assert len(timed) == 3
    data = json.loads(path.read_text())
    (key, entry), = data.items()
    assert key == f"{tuning._SCHEMA}|NVIDIA H100 80GB HBM3|pipeline|1"
    assert key == tuning._disk_key(("pipeline", 1))
    assert entry == {"blocks": [8, 7], "probe_madd_ps": 0.5,
                     "ref_madd_ps": 0.5}
    # measure_top cuts the list: only the first candidate is timed.
    tuning._CACHE.clear()
    times.update({(16, 13): 2e-3, (8, 7): 1e-3})
    assert tuning._tune(("pipeline", 2), cands, build, 1) == (16, 13)


def test_tune_key_names_the_card(tune_env, monkeypatch):
    """Another card's winner does not answer for this one."""
    path, times, build, _ = tune_env
    times.update({(16, 13): 2e-3, (8, 7): 1e-3})
    tuning._tune(("volume", 1), [(16, 13), (8, 7)], build, 6)
    tuning._CACHE.clear()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H200")
    times[(16, 13)] = 0.5e-3
    assert tuning._tune(("volume", 1), [(16, 13), (8, 7)], build,
                        6) == (16, 13)
    assert len(json.loads(path.read_text())) == 2


def test_tune_degraded_window_and_bare_list(tune_env, monkeypatch):
    """A winner measured in a degraded window stays in process, with a
    warning; a bare-list disk entry (the JAX cache's first form) loads."""
    path, times, build, _ = tune_env
    times[(16, 13)] = 1e-3
    monkeypatch.setattr(tuning, "_probe_health",
                        lambda: (False, 10.0e-12, 0.5e-12))
    with pytest.warns(RuntimeWarning, match="degraded"):
        assert tuning._tune(("t", 1), [(16, 13)], build, 2) == (16, 13)
    assert not path.exists()
    assert tuning._tune(("t", 1), [(16, 13)], build, 2) == (16, 13)
    # No probe (no card to ask): persisted without its stamp.
    monkeypatch.setattr(tuning, "_probe_health", lambda: (None, None, None))
    assert tuning._tune(("t", 2), [(16, 13)], build, 2) == (16, 13)
    assert json.loads(path.read_text())[tuning._disk_key(("t", 2))] == {
        "blocks": [16, 13]}
    data = json.loads(path.read_text())
    data[tuning._disk_key(("t", 3))] = [8, 7]
    path.write_text(json.dumps(data))
    tuning._CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tuning._tune(("t", 3), [], build, 0) == (8, 7)


def test_tune_raises_when_every_candidate_fails(tune_env):
    """Every candidate raising gives a RuntimeError naming the first
    failures, an empty message included; a failing candidate beside a
    working one is skipped."""
    path, times, build, _ = tune_env

    def failing(rows, planes):
        if rows == 8:
            raise ValueError("")
        if rows == 32:
            raise RuntimeError("K3 fused pipeline launch: CUDA error 9\n"
                               "second line")
        return lambda: times[(rows, planes)]

    with pytest.raises(RuntimeError, match=r"no autotune candidate ran \(2 "
                       r"tried\).*\(8, 7\): ValueError: ;.*\(32, 10\): "
                       r"RuntimeError: K3 fused pipeline launch: CUDA error "
                       r"9$"):
        tuning._tune(("x", 1), [(8, 7), (32, 10)], failing, 6)
    assert not path.exists()
    times[(16, 13)] = 1e-3
    assert tuning._tune(("x", 2), [(8, 7), (16, 13)], failing, 6) == (16, 13)


def test_tune_picks_what_jax_picks(tune_env, tmp_path, monkeypatch):
    """The same candidates and timings through the JAX package's ``_tune``
    (its clock stubbed the same way) and the port's: the same winner,
    cached on both sides."""
    path, times, build, _ = tune_env
    rng = np.random.default_rng(3)
    cands = [(16, 13), (8, 7), (8, 14), (32, 10), (16, 20)]
    times.update({c: float(t) for c, t in zip(cands, rng.random(5))})
    monkeypatch.setattr(jax_tuning, "_CACHE", {})
    monkeypatch.setenv("CUSTEREO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(jax_tuning, "_slope_time",
                        lambda fn, args: fn(*args))
    for top in (5, 3, 1):
        want = jax_tuning._tune(("p", top), cands,
                                lambda r, p: (lambda: times[(r, p)], ()),
                                top, probe=False)
        monkeypatch.setenv("CUSTEREO_TUNE_CACHE", str(path))
        assert tuning._tune(("p", top), cands, build, top,
                            probe=False) == want
        monkeypatch.setenv("CUSTEREO_TUNE_CACHE", str(tmp_path / "jax.json"))


def test_the_default_is_always_measured():
    """The tuner times the model's top few, the default tile in place of
    the last where the model ranks it lower."""
    ranked = [(32, 10), (32, 17), (8, 7), (16, 13), (16, 6)]
    assert tuning._measured(ranked, (16, 13), 6) == ranked
    assert tuning._measured(ranked, (16, 13), 3) == [(32, 10), (32, 17),
                                                     (16, 13)]
    assert tuning._measured(ranked, (32, 10), 2) == [(32, 10), (32, 17)]
    assert tuning._measured([], (16, 13), 6) == []


def test_tuner_entry_points_need_a_card():
    """Nothing to tune on the plain versions: without a card the entry
    points raise, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (tuning.autotune_pipeline_blocks, tuning.autotune_volume_blocks,
               tuning.autotune_trainable_bwd_blocks):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(24, 40, 6, 5)
    assert tuning._probe_health() == (None, None, None)
    assert tuning._cached_rates() is None


# ---------------------------------------------------------------------------
# The engine, the config and the wrappers
# ---------------------------------------------------------------------------

def test_engine_autotune_per_bucket(monkeypatch):
    """Each bucket gets its own tuned tile on first use (the tuner stubbed;
    on the CPU the engine is switched to tuning by hand, since off the card
    there is nothing to tune), and the maps equal the JAX package's
    ``disparity_maps`` on the same inputs."""
    calls = []

    def fake_tune(h, w, D, k, **kw):
        calls.append((h, w, D, k))
        return (8, 7)

    monkeypatch.setattr(tuning, "autotune_pipeline_blocks", fake_tune)
    cfg = StereoConfig(kernel_size=5, num_disparities=8)
    eng = StereoEngine(cfg, buckets=[(16, 64), (32, 128)], device="cpu")
    assert not eng.autotune
    eng.autotune = True
    cam, proj = _pair(0, 14, 60)
    out = eng.infer(cam[0], proj[0])
    assert calls == [(16, 64, 8, 5)]
    assert eng.tuned_tiles == {(16, 64): (8, 7)}
    eng.infer(cam[0], proj[0])
    assert calls == [(16, 64, 8, 5)]        # tuned once a bucket
    eng.warmup()
    assert calls == [(16, 64, 8, 5), (32, 128, 8, 5)]
    jcfg = JaxStereoConfig(kernel_size=5, num_disparities=8, backend="xla")
    pad = ((0, 0), (0, 2), (0, 4))
    want = JaxMatcher(jcfg).disparity_maps(jnp.asarray(np.pad(cam, pad)),
                                           jnp.asarray(np.pad(proj, pad)))
    np.testing.assert_array_equal(out.disparity,
                                  np.asarray(want.disparity)[0, :14, :60])
    np.testing.assert_allclose(out.soft_disparity,
                               np.asarray(want.soft_disparity)[0, :14, :60],
                               rtol=1e-4, atol=1e-5)


def test_config_card_tile():
    """``pipeline_blocks`` is K3's tile and ``trainable_bwd_block_rows``
    K4's rows on the card, validated as in the JAX package (a JAX config
    carries over unchanged); the torch backend ignores them."""
    assert StereoConfig().pipeline_tile() == DEFAULT_TILE == (16, 0)
    assert StereoConfig().bwd_tile_rows() == 16
    cfg = StereoConfig(pipeline_blocks=[8, 7], trainable_bwd_block_rows=32)
    assert cfg.pipeline_tile() == (8, 7) and cfg.bwd_tile_rows() == 32
    for bad in (dict(pipeline_blocks=(8, 0)), dict(pipeline_blocks=(8,)),
                dict(trainable_bwd_block_rows=0)):
        with pytest.raises(ValueError):
            StereoConfig(**bad)
    jax_cfg = JaxStereoConfig(num_disparities=8, kernel_size=5,
                              pipeline_blocks=(32, 40),
                              trainable_bwd_block_rows=48, backend="xla")
    port = config_from_jax(dataclasses.asdict(jax_cfg))
    assert port.pipeline_tile() == (32, 40) and port.bwd_tile_rows() == 48
    cam, proj = (torch.from_numpy(x) for x in _pair(1, 20, 48))
    plain = StereoMatcher(dataclasses.replace(port, pipeline_blocks=None,
                                              trainable_bwd_block_rows=None))
    for a, b in zip(StereoMatcher(port).disparity_maps(cam, proj),
                    plain.disparity_maps(cam, proj)):
        assert torch.equal(a, b)


@pytest.fixture
def h100(monkeypatch):
    """The wrappers' card budget, an H100's, without a card."""
    monkeypatch.setattr(cuda_zncc, "smem_floats", lambda device: LIMIT)


@pytest.mark.parametrize("kernel, tile, runs", [
    ("K3", (16, 0), True), ("K3", (16, 13), True), ("K3", (8, 21), True),
    ("K3", (32, 17), True), ("K1", (32, 0), True), ("K4", (8, 0), True),
    ("K3", (24, 40), False), ("K3", (32, 40), False), ("K1", (16, 24), False),
    ("K3m", (8, -1), False), ("K4", (12, 0), False)])
def test_wrappers_refuse_a_tile_that_does_not_fit(h100, kernel, tile, runs):
    """A tile the card cannot run at the call's shape raises ValueError
    before any launch, naming ``candidate_blocks``' list; it is never
    changed for another."""
    cam = torch.zeros((1,) + KITTI[:2])
    D, k = KITTI[2:]
    if runs:
        assert own_blocks(kernel, cam, D, k, *tile)
        return
    kind = cuda_zncc.TILE_KINDS[kernel]
    with pytest.raises(ValueError) as err:
        own_blocks(kernel, cam, D, k, *tile)
    assert f"candidate_blocks({kind!r}) gives" in str(err.value)
    assert str(tuning.candidate_blocks(kind, *KITTI)) in str(err.value)


def test_wrappers_route_at_the_default_tile_only(h100):
    """At k = 129 the default tile takes the large-k route (False: no own
    blocks); 32 rows still run their own; 8 rows are refused."""
    cam = torch.zeros((1, 40, 130))
    assert not own_blocks("K3", cam, 24, 129)
    assert own_blocks("K3", cam, 24, 129, 32, 0)
    with pytest.raises(ValueError, match=r"gives \[\(32, 1\)\]"):
        own_blocks("K3", cam, 24, 129, 8, 0)


def test_plain_versions_take_any_tile():
    """CPU tensors take the plain versions, which have no tile: the same
    values for any tile argument."""
    cam, proj = (torch.from_numpy(x) for x in _pair(2, 18, 40))
    want = cost_volume_banded_cuda(cam, proj, 6, 5)
    assert torch.equal(cost_volume_banded_cuda(cam, proj, 6, 5, 1e-8, 32, 3),
                       want)
    a = stereo_pipeline_trainable_reference(cam, proj, 6, 5, tile_rows=8,
                                            planes=4, bwd_tile_rows=32)
    b = stereo_pipeline_trainable_reference(cam, proj, 6, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    cfg = StereoConfig(kernel_size=5, num_disparities=6)
    tiled = dataclasses.replace(cfg, pipeline_blocks=(32, 3),
                                trainable_bwd_block_rows=8)
    for x, y in zip(StereoMatcher(tiled).disparity_maps(cam, proj),
                    stereo_pipeline_reference(cam, proj, 6, 5)):
        assert torch.equal(x, y)


def test_tiles_mirror_the_sources():
    """The tiles the model knows are the ones the sources instantiate:
    each non-default tile has a translation unit for K1/K3 and for K4,
    the dispatches name them, and the C entries take the tile after the
    stream (so a caller that passes none runs the default of an older
    library)."""
    common = (CSRC / "common.cuh").read_text()
    fused = (CSRC / "fused_pipeline.cuh").read_text()
    bwd = (CSRC / "fused_pipeline_bwd.cu").read_text()
    assert "static_assert(Tile<8>::kW % kRoundCols == 0" in common
    for rows in km.TILE_ROWS:
        if rows == km.K_TILE_H:
            continue
        assert f"return run_outputs<{rows}>(c);" in (
            CSRC / f"fused_pipeline_tile{rows}.cu").read_text()
        assert f"return head_rounds_call<{rows}>(c);" in (
            CSRC / f"fused_pipeline_bwd_tile{rows}.cu").read_text()
        assert (f"case {rows}:\n      return run_pipeline_tile{rows}(c);"
                in fused)
        assert f"tile_rows != {rows}" in bwd
    for name in ("custereo_banded_volume", "custereo_fused_pipeline",
                 "custereo_fused_pipeline_train",
                 "custereo_fused_pipeline_train_maps"):
        assert _build.SIGNATURES[name][-3:] == [_build._P, _build._I,
                                                _build._I]
    assert _build.SIGNATURES["custereo_fused_pipeline_bwd"][-2:] == [
        _build._P, _build._I]
