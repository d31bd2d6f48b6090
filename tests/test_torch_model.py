"""PyTorch port: StereoMatcher, StereoEngine, entry(), the numpy data copy
and the timer, held against the JAX package on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.data import synthetic as jax_synthetic
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu_torch import (
    StereoConfig,
    StereoEngine,
    StereoMatcher,
    Timer,
    TimerError,
    benchmark,
    config_from_jax,
)
from custereomatching_tpu_torch.data import synthetic
from custereomatching_tpu_torch.examples import train as train_example
from custereomatching_tpu_torch.examples import verify as verify_example
from custereomatching_tpu_torch.models import entry
from custereomatching_tpu_torch.utils import fence


def _batch(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return (rng.random((B, H, W), dtype=np.float32),
            rng.random((B, H, W), dtype=np.float32))


def _assert_maps_close(got, want):
    """The JAX suite's head tolerances (tests/test_pallas_zncc.py)."""
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(want.confidence),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.soft_disparity.numpy(),
                               np.asarray(want.soft_disparity),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("jax_backend,shape", [
    ("pallas_interpret", (2, 16, 48, 6, 5)),
    ("xla", (1, 96, 160, 64, 15)),            # the entry() shape
])
def test_matcher_matches_jax(jax_backend, shape):
    B, H, W, D, K = shape
    jcfg = JaxStereoConfig(kernel_size=K, num_disparities=D,
                           backend=jax_backend)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.backend == "torch"
    cam, proj = _batch(4, B, H, W)
    jmodel = JaxStereoMatcher(jcfg)
    model = StereoMatcher(cfg)
    cam_t, proj_t = torch.from_numpy(cam), torch.from_numpy(proj)

    want = jmodel(jnp.asarray(cam), jnp.asarray(proj))
    got = model(cam_t, proj_t)
    assert got.cost_volume.shape == (B, H, W, D + 1)
    np.testing.assert_allclose(got.cost_volume.numpy(),
                               np.asarray(want.cost_volume),
                               rtol=1e-4, atol=1e-5)
    _assert_maps_close(got, want)

    want_maps = jmodel.disparity_maps(jnp.asarray(cam), jnp.asarray(proj))
    got_maps = model.disparity_maps(cam_t, proj_t)
    _assert_maps_close(got_maps, want_maps)
    np.testing.assert_array_equal(
        model.cost_volume_single(cam_t[0], proj_t[0]).numpy(),
        got.cost_volume[0].numpy())


def test_entry_matches_graft_entry():
    jforward, jargs = __graft_entry__.entry()
    forward, args = entry("cpu")
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(forward(*args).numpy(),
                               np.asarray(jforward(*jargs)),
                               rtol=1e-3, atol=1e-3)


def test_engine_crop_is_exact():
    """Zero-padding to the bucket and cropping back changes nothing."""
    cfg = StereoConfig(kernel_size=5, num_disparities=6)
    engine = StereoEngine(cfg, buckets=[(32, 64), (16, 24)], device="cpu")
    engine.warmup()
    assert engine.warm == {(16, 24), (32, 64)}
    cam, proj = _batch(5, 2, 20, 50)
    want = StereoMatcher(cfg).disparity_maps(torch.from_numpy(cam),
                                             torch.from_numpy(proj))
    got = engine.infer(cam, proj)
    single = engine.infer(cam[1], proj[1])
    for g, s, w in zip(got, single, want):
        assert isinstance(g, np.ndarray) and g.shape == (2, 20, 50)
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(s, w[1].numpy())
    with pytest.raises(ValueError, match="exceeds every bucket"):
        engine.infer(np.zeros((40, 10)), np.zeros((40, 10)))


@pytest.mark.parametrize("option", [dict(autotune=True)])
def test_engine_autotune_off_the_card_tunes_nothing(option):
    """``autotune`` is a no-op off the card: the plain versions have no
    tile, so the engine tunes nothing and serves the untuned maps."""
    cfg = StereoConfig(kernel_size=3, num_disparities=4)
    engine = StereoEngine(cfg, buckets=[(16, 24)], device="cpu", **option)
    plain = StereoEngine(cfg, buckets=[(16, 24)], device="cpu")
    assert not engine.autotune
    engine.warmup()
    assert engine.tuned_tiles == {}
    cam, proj = _batch(7, 1, 12, 20)
    for g, w in zip(engine.infer(cam, proj), plain.infer(cam, proj)):
        np.testing.assert_array_equal(g, w)


def test_cuda_backend_on_cpu_tensors_raises():
    cfg = StereoConfig(kernel_size=3, num_disparities=2, backend="cuda")
    x = torch.zeros((1, 6, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        StereoMatcher(cfg)(x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        StereoMatcher(cfg).disparity_maps(x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        StereoEngine(cfg, device="cpu")


@pytest.mark.parametrize("call,item", [
    ("sharded_cost_volume", "parallel/"), ("sharded_apply", "parallel/"),
])
def test_unported_model_paths_raise(call, item):
    """Named for when these paths raised (``parallel/`` was not ported):
    now they run, on a 1 x 1 mesh of a gloo world of one, and give the
    unsharded call's values bit for bit, as ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    from custereomatching_tpu_torch.config import MeshConfig
    from custereomatching_tpu_torch.parallel import make_mesh
    from tests.torch_parallel_ranks import world_of_one

    assert item == "parallel/"
    cam, proj = (torch.from_numpy(a) for a in _batch(9, 2, 16, 24))
    model = StereoMatcher(StereoConfig(kernel_size=5, num_disparities=6))
    with world_of_one():
        got = getattr(model, call)(cam, proj,
                                   make_mesh(MeshConfig(1, 1), "cpu"))
        got = got if call == "sharded_apply" else (got,)
        assert all(isinstance(x, DTensor) for x in got)
        got = [x.full_tensor() for x in got]
    want = model(cam, proj)
    want = want if call == "sharded_apply" else (want.cost_volume,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _train_argv(tmp_path):
    return ["--height", "12", "--width", "32", "--frames", "1", "-D", "4",
            "-k", "3", "--steps", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]


_VERIFY_ARGV = ["--height", "12", "--width", "24", "-D", "4", "-k", "3",
                "--skip-allpairs"]
_ENGINE_CFG = StereoConfig(kernel_size=3, num_disparities=2)


def _entry_ran_on_cpu(tmp_path) -> bool:
    forward, args = entry("cpu")
    soft = forward(*args)
    return soft.device.type == "cpu" and tuple(soft.shape) == (1, 96, 160)


def _engine_ran_on_cpu(tmp_path) -> bool:
    engine = StereoEngine(_ENGINE_CFG, buckets=[(8, 16)], device="cpu")
    return engine.infer(np.zeros((6, 10)), np.zeros((6, 10))).mask.shape \
        == (6, 10)


def _train_ran_on_cpu(tmp_path) -> bool:
    train_example.main(_train_argv(tmp_path) + ["--device", "cpu"])
    return (tmp_path / "step_00000001.pt").is_file()


@pytest.mark.parametrize("run,run_cpu", [
    (lambda tmp: entry(), _entry_ran_on_cpu),
    (lambda tmp: StereoEngine(_ENGINE_CFG), _engine_ran_on_cpu),
    (lambda tmp: train_example.main(_train_argv(tmp)), _train_ran_on_cpu),
    (lambda tmp: verify_example.main(_VERIFY_ARGV),
     lambda tmp: verify_example.main(_VERIFY_ARGV + ["--device", "cpu"])
     == 0),
], ids=["entry", "engine", "train", "verify"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(
        run, run_cpu, monkeypatch, tmp_path):
    """entry(), StereoEngine and the two examples run on the card by
    default: without one they raise, naming the CPU option, and with the
    CPU asked for they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"|--device cpu'):
        run(tmp_path)
    assert run_cpu(tmp_path)


@pytest.mark.parametrize("kwargs", [
    dict(scene="slant", d_min=2.0, d_max=9.0, seed=3),
    dict(scene="box", d_min=1.0, d_max=5.0, noise=0.05, seed=4),
])
def test_synthetic_copy_matches_jax_package(kwargs):
    for got, want in zip(synthetic.make_stereo_pair(24, 40, **kwargs),
                         jax_synthetic.make_stereo_pair(24, 40, **kwargs)):
        np.testing.assert_array_equal(got, want)


def test_timer_and_fence():
    t = Timer(start=True)
    assert t.since_start() >= 0.0
    with pytest.raises(TimerError):
        Timer(start=False).since_last_check()
    x = torch.ones(3)
    assert fence((x, {"y": x}))[0] is x


def test_benchmark_needs_a_card():
    """Device times come from the card only; without one, it raises."""
    if torch.cuda.is_available():
        stats = benchmark(torch.mul, torch.ones(8, device="cuda"), 2.0,
                          warmup=1, iters=3)
        assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark(torch.mul, torch.ones(8), 2.0)
