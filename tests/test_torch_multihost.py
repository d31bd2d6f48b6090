"""PyTorch port: the multi-host surface (``parallel/multihost.py``,
``parallel/mesh.py``) on real process boundaries.

The counterpart of tests/test_multihost.py, case by case: a lone process
gets a world of one; more processes without a coordinator raise; the
global mesh covers exactly the world's ranks; each rank's batch slice; a
sharded train step on the global mesh, against the JAX package's step on
the same inputs.  Multi-rank cases run on 4 spawned gloo ranks (one
spawn), as JAX's run on its virtual CPU devices; ``spawn_ranks`` itself
must fail, not hang, when a rank raises or a collective never returns.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.distributed as dist

from custereomatching_tpu.config import MeshConfig as JaxMeshConfig
from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.models import init_state, make_train_step
from custereomatching_tpu.parallel import make_mesh as jax_make_mesh
from custereomatching_tpu.parallel import shard_batch as jax_shard_batch
from custereomatching_tpu_torch.config import MeshConfig
from custereomatching_tpu_torch.parallel import (
    default_mesh_config,
    initialize_multihost,
    make_global_mesh,
    process_local_batch_slice,
    spawn_ranks,
)
from tests import torch_parallel_ranks as ranks

# test_global_mesh_runs_sharded_step's inputs at B = 2 (its mesh is 2 x 2).
_rng = np.random.default_rng(0)
STEP = (_rng.random((2, 16, 32), dtype=np.float32),
        _rng.random((2, 16, 32), dtype=np.float32))


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        torch_runs = pool.submit(spawn_ranks, ranks.multihost_suite, 4,
                                 (STEP,))
        model = JaxStereoMatcher(JaxStereoConfig(kernel_size=5,
                                                 num_disparities=8))
        mesh = jax_make_mesh(JaxMeshConfig(data=2, space=2))
        cam, proj, target = jax_shard_batch(
            (*map(jnp.asarray, STEP), jnp.zeros(STEP[0].shape, jnp.float32)),
            mesh)
        optimizer = optax.adam(1e-2)
        _, metrics = make_train_step(model, optimizer, mesh)(
            init_state(cam, optimizer), proj, target)
        return torch_runs.result(), float(metrics.loss)


def test_initialize_singleprocess_noop():
    """A lone process with no launcher's environment gets a world of one
    (gloo, as asked); a second call is a no-op."""
    with ranks.world_of_one():
        initialize_multihost(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()


def test_initialize_explicit_multiprocess_raises():
    """Asking for N > 1 processes without a coordinator fails loudly, as
    does a rank outside the world."""
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        initialize_multihost("127.0.0.1:1", num_processes=2, process_id=2,
                             device="cpu")
    assert not dist.is_initialized()


def test_make_global_mesh_full_cover(runs):
    results, _ = runs
    for r in results:
        assert r["world"] == 4
        assert r["mesh"] == (("data", "space"), (2, 2), [0, 1, 2, 3])


def test_make_global_mesh_rejects_partial_cover(runs):
    """The global mesh must cover exactly all ranks of the world."""
    results, _ = runs
    assert "global devices" in results[0]["partial"]


def test_process_local_batch_slice_single_process():
    s = process_local_batch_slice(12)
    assert (s.start, s.stop) == (0, 12)
    batch = np.arange(12)
    assert np.array_equal(batch[s], batch)


def test_process_local_batch_slice_arithmetic(runs):
    """Per-rank slices partition the batch across the 4 ranks."""
    results, _ = runs
    seen = []
    for r in results:
        s = r["slice"]
        assert s.stop - s.start == 4
        seen.extend(range(s.start, s.stop))
    assert seen == list(range(16))


def test_global_mesh_runs_sharded_step(runs):
    """The global mesh drives the real sharded train step: every rank gets
    the JAX step's loss."""
    results, want = runs
    for r in results:
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], want, rtol=1e-4)


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)),
                                    (8, (4, 2))])
def test_default_mesh_config(n, want):
    assert default_mesh_config(n).shape == want
    assert default_mesh_config(n) == MeshConfig(*want)


def test_spawn_ranks_fails_without_hanging():
    """A rank that raises ends the run with its traceback; a rank that
    never returns is ended at the timeout."""
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn_ranks(ranks.fail_on_rank_one, 2, timeout=60.0)
    with pytest.raises(RuntimeError, match="0 of 1 ranks returned"):
        spawn_ranks(ranks.hang, 1, timeout=3.0)
