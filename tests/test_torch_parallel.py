"""PyTorch port: the sharded pipeline (``parallel/``: halo exchange,
``(data, space)`` sharding) on spawned gloo ranks, held against the JAX
package's shard_map functions on its 8 virtual CPU devices.

The counterpart of tests/test_parallel.py, case by case and at its
shapes, with its tolerances.  Meshes (1, 1), (2, 1), (1, 4) and (2, 2)
run on 4 gloo ranks in one spawn (the JAX suite's (2, 4) needs 8); the
JAX references run in the pytest process meanwhile.  Each sharded torch
forward is also held bit for bit against the torch unsharded call.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from custereomatching_tpu.config import MeshConfig as JaxMeshConfig
from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.models import (
    init_state as jax_init_state,
    make_train_step as jax_make_train_step,
    optimize_camera as jax_optimize_camera,
)
from custereomatching_tpu.parallel import halo_exchange as jax_halo_exchange
from custereomatching_tpu.parallel import make_mesh as jax_make_mesh
from custereomatching_tpu.parallel import shard_batch as jax_shard_batch
from custereomatching_tpu.parallel import (
    sharded_cost_volume as jax_sharded_cost_volume,
    sharded_disparity_maps as jax_sharded_disparity_maps,
)
from custereomatching_tpu_torch.parallel import spawn_ranks
from tests import torch_parallel_ranks as ranks


def _batch(rng, B, H, W):
    return (rng.random((B, H, W), dtype=np.float32),
            rng.random((B, H, W), dtype=np.float32))


# The JAX suite's inputs (tests/test_parallel.py), seed for seed.
VOL = _batch(np.random.default_rng(0), 2, 24, 20)
GRAD = _batch(np.random.default_rng(1), 1, 16, 12)
PALLAS = _batch(np.random.default_rng(5), 2, 24, 40)
FUSED = _batch(np.random.default_rng(6), 2, 32, 48)
TRAIN = _batch(np.random.default_rng(3), 2, 16, 20)


def _opt_inputs():
    """test_optimize_camera_reduces_loss's camera, projector and target."""
    rng = np.random.default_rng(2)
    B, H, W, D = 1, 16, 24, 6
    model = JaxStereoMatcher(JaxStereoConfig(kernel_size=5,
                                             num_disparities=D))
    proj = jnp.asarray(rng.random((B, H, W), dtype=np.float32))
    true_cam = jnp.roll(proj, 3, axis=2)
    target = model(true_cam, proj).soft_disparity
    cam0 = true_cam + 0.1 * jnp.asarray(
        rng.standard_normal((B, H, W)).astype(np.float32))
    return tuple(np.asarray(x) for x in (cam0, proj, target))


OPT = _opt_inputs()


def _jax_mesh(shape):
    return jax_make_mesh(JaxMeshConfig(data=shape[0], space=shape[1]))


def _jax_references():
    ref = {}
    for D in (6, None):
        cfg = JaxStereoConfig(kernel_size=5, num_disparities=D)
        mesh = _jax_mesh((2, 2))
        cam, proj = jax_shard_batch(tuple(map(jnp.asarray, VOL)), mesh)
        ref["volume", D] = np.asarray(
            jax_sharded_cost_volume(cam, proj, cfg, mesh))

    mesh = _jax_mesh((1, 4))
    x = jnp.arange(32 * 16, dtype=jnp.float32).reshape(1, 32, 16)
    spec = jax.sharding.PartitionSpec("data", "space", None)
    halo = jax.shard_map(lambda b: jax_halo_exchange(b, 3, "space", axis=1),
                         mesh=mesh, in_specs=spec, out_specs=spec)
    ref["halo"] = halo
    ref["halo_x"] = x

    cfg = JaxStereoConfig(kernel_size=3, num_disparities=4)
    cam, proj = jax_shard_batch(tuple(map(jnp.asarray, GRAD)), mesh)
    ref["grad"] = np.asarray(jax.grad(lambda c: jnp.sum(
        jax_sharded_cost_volume(c, proj, cfg, mesh) ** 2))(cam))

    model = JaxStereoMatcher(JaxStereoConfig(kernel_size=5,
                                             num_disparities=6))
    _, losses = jax_optimize_camera(model, *map(jnp.asarray, OPT),
                                    learning_rate=1e-3, num_steps=30)
    ref["opt_losses"] = np.asarray(losses)

    mesh = _jax_mesh((2, 2))
    cfg_pl = JaxStereoConfig(kernel_size=5, num_disparities=6,
                             backend="pallas_interpret")
    cam, proj = jax_shard_batch(tuple(map(jnp.asarray, PALLAS)), mesh)
    ref["pallas_volume"] = np.asarray(
        jax_sharded_cost_volume(cam, proj, cfg_pl, mesh))

    cam, proj = jax_shard_batch(tuple(map(jnp.asarray, FUSED)), mesh)
    ref["fused"] = [np.asarray(m) for m in
                    jax_sharded_disparity_maps(cam, proj, cfg_pl, mesh)]
    target = jnp.zeros(cam.shape)
    ref["fused_grad"] = np.asarray(jax.grad(lambda c: jnp.mean((
        jax_sharded_disparity_maps(c, proj, cfg_pl, mesh,
                                   trainable=True).soft_disparity
        - target) ** 2))(cam))

    model = JaxStereoMatcher(JaxStereoConfig(kernel_size=3,
                                             num_disparities=4))
    cam, proj, target = jax_shard_batch(
        (*map(jnp.asarray, TRAIN), jnp.zeros(TRAIN[0].shape, jnp.float32)),
        mesh)
    optimizer = optax.adam(1e-2)
    _, metrics = jax_make_train_step(model, optimizer, mesh)(
        jax_init_state(cam, optimizer), proj, target)
    ref["train"] = (float(metrics.loss), float(metrics.grad_norm))
    return ref


@pytest.fixture(scope="module")
def runs():
    """(the 4 ranks' results, the JAX references), computed together."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        torch_runs = pool.submit(spawn_ranks, ranks.parallel_suite, 4,
                                 (VOL, GRAD, PALLAS, FUSED, TRAIN, OPT))
        ref = _jax_references()
        return torch_runs.result(), ref


@pytest.mark.parametrize("mesh_shape", ranks.MESHES)
@pytest.mark.parametrize("banded", [True, False])
def test_sharded_cost_volume_parity(runs, mesh_shape, banded):
    """Sharded volume == the JAX sharded volume for every mesh layout,
    and == the torch unsharded volume bit for bit."""
    (out, *_), ref = runs
    D = 6 if banded else None
    np.testing.assert_allclose(out["volume"][mesh_shape, D],
                               ref["volume", D], rtol=1e-5, atol=1e-6)
    assert out["volume_plain"][mesh_shape, D]


def test_halo_exchange_matches_global_rows(runs):
    """Halo-extended blocks reproduce the global rows (zeros at the
    borders) as JAX's ppermute delivers them; the backward returns each
    halo slab's cotangent to the rank that owns its rows."""
    results, ref = runs
    blocks = np.stack([r["halo"][0][0] for r in results])
    want = np.asarray(ref["halo"](ref["halo_x"])).reshape(4, 14, 16)
    np.testing.assert_array_equal(blocks, want)
    xg = np.asarray(ref["halo_x"][0])
    padded = np.concatenate([np.zeros((3, 16), np.float32), xg,
                             np.zeros((3, 16), np.float32)])
    for s in range(4):
        np.testing.assert_array_equal(blocks[s], padded[s * 8:s * 8 + 14])
    # d/dx sum(w * blocks) through JAX's shard_map, w the ranks' weights.
    w = jnp.asarray(np.concatenate([r["halo"][1] for r in results], axis=1))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        ref["halo"](x) * w))(ref["halo_x"]))
    got_g = np.concatenate([r["halo"][2] for r in results], axis=1)
    np.testing.assert_array_equal(got_g, want_g)


def test_sharded_gradient_parity(runs):
    """Camera gradient through the sharded volume (halo transpose
    included) matches JAX's sharded gradient."""
    (out, *_), ref = runs
    np.testing.assert_allclose(out["grad"], ref["grad"], rtol=1e-4,
                               atol=1e-5)


def test_halo_larger_than_shard_raises(runs):
    (out, *_), _ = runs
    assert "exceeds local shard extent" in out["halo_raises"]


def test_optimize_camera_reduces_loss(runs):
    """optimize_camera with a (1, 4) mesh lowers the disparity loss, along
    the JAX package's losses."""
    (out, *_), ref = runs
    losses = out["opt_losses"]
    assert losses.shape == (30,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref["opt_losses"], rtol=1e-4)


def test_sharded_pallas_cost_volume_parity(runs):
    """At the JAX suite's Pallas shape: the torch sharded volume against
    the JAX sharded Pallas kernel (interpret mode)."""
    (out, *_), ref = runs
    np.testing.assert_allclose(out["pallas_volume"], ref["pallas_volume"],
                               rtol=1e-4, atol=1e-5)


def test_sharded_fused_pipeline_parity_and_grad(runs):
    """Fused pipeline under (data, space) sharding: maps against JAX's
    sharded fused pipeline, bit-equal to the torch unsharded maps; the
    trainable pipeline's camera gradient against JAX's."""
    (out, *_), ref = runs
    got, want = out["fused"], ref["fused"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    assert out["fused_plain"]
    np.testing.assert_allclose(out["fused_grad"], ref["fused_grad"],
                               rtol=1e-3, atol=1e-6)


def test_sharded_train_step_runs(runs):
    """One sharded train step: finite metrics, the JAX step's loss and
    grad norm.  (Adam's first update is lr·sign(g) wherever |g| >> eps, so
    the updated camera is not compared: where g is near 0 its sign is
    rounding.)"""
    (out, *_), ref = runs
    loss, grad_norm, step = out["train"]
    assert np.isfinite(loss) and np.isfinite(grad_norm) and step == 1
    np.testing.assert_allclose(loss, ref["train"][0], rtol=1e-4)
    np.testing.assert_allclose(grad_norm, ref["train"][1], rtol=1e-4)
